"""The training phases of `chip_smoke.py` alone, on one CUDA card: 30 steps
each of SwinIR-M, HAT-M, DAT, Swin2SR-M, SwinIR-M OTF and SRFormerV2, and
SwinIR-M GAN where the tree's `chip_smoke.py` has it, each printing its
median ms per step with the quartiles; after each, the device time of one
of its steps (`torch.profiler`) and the card's busy share.

Run it from the root of the tree to measure; it imports that tree's
`chip_smoke.py` and package. To compare two trees on one card, run it in
turns (A, B, B, A) in one session:

    cd <tree> && python3 /path/to/chip_train_steps.py
"""

import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402

seed = 0
cs.phase_device()
cs.phase_build()
cs.phase_train(seed)
cs.phase_train_profile(seed)
cs.phase_train(seed, "hat_m", "HAT-M", "hat train",
               {"fused_window_mhsa": cs.HAT_BLOCKS, "fused_window_mhsa_backward": cs.HAT_BLOCKS,
                "fused_ln_mlp": cs.HAT_MLPS, "fused_ln_mlp_backward": cs.HAT_MLPS},
               cs.hat_serving_counts())
cs.phase_train_profile(seed, "hat_m", "hat train profile", "profile_hat_train.txt")
cs.phase_train(seed, "dat", "DAT", "dat train",
               {"fused_rect_mhsa": cs.DAT_RECT, "fused_rect_mhsa_backward": cs.DAT_RECT},
               cs.dat_serving_counts(), cs.DAT_LQ, ("l1loss", "mssimloss"))
cs.phase_train_profile(seed, "dat", "dat train profile", "profile_dat_train.txt", cs.DAT_LQ,
                       ("l1loss", "mssimloss"))
cs.phase_train(seed, "swin2sr_m", "Swin2SR-M", "swin2sr train",
               {k: cs.SWIN2SR_BLOCKS for k in ("fused_cos_attn_block",
                                               "fused_cos_attn_block_backward",
                                               "fused_postnorm_mlp", "fused_postnorm_mlp_backward")},
               cs.swin2sr_serving_counts(), cs.S2_LQ, cs.S2_LOSSES)
cs.phase_train_profile(seed, "swin2sr_m", "swin2sr train profile", "profile_swin2sr_train.txt",
                       cs.S2_LQ, cs.S2_LOSSES)
hr_dir, _ = cs.make_dataset(cs.OUT / "otf_data", seed, ((128, 128),) * 16)
cs.phase_otf_train(seed, hr_dir)
cs.phase_otf_profile(seed, hr_dir)
cs.phase_train(seed, "srformerv2", "SRFormerV2", "srformerv2 train",
               {k: cs.SRF_SWIN for k in ("fused_attn_block", "fused_attn_block_backward",
                                         "fused_ln_mlp", "fused_ln_mlp_backward")},
               cs.srformerv2_serving_counts(), cs.SRF_LQ, cs.S2_LOSSES)
cs.phase_train_profile(seed, "srformerv2", "srformerv2 train profile",
                       "profile_srformerv2_train.txt", cs.SRF_LQ, cs.S2_LOSSES)
if hasattr(cs, "phase_gan_train"):  # trees from the GAN slice on
    cs.phase_gan_train(seed)
    cs.phase_gan_profile(seed)
print("steps ok", flush=True)
