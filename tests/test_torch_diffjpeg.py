"""DiffJPEG and its block transform (kernel #15), torch port vs JAX package,
on the CPU (the port's wrapper runs its plain version; the JAX kernel runs
in Pallas interpret mode).

- `jpeg_block_transform_reference` against the interpret-mode Pallas kernel
  and against the JAX einsum form, at (2, 100, 64) (the JAX kernel test's
  inputs): within 1e-3 absolute (that test's tolerance; spatial values in
  [-128, 127]). A block with a coefficient within 1e-4 of a rounding tie,
  where the differentiable round jumps by 3/4 of the table entry, is left
  out of the comparison and counted: one of the 200;
- `diff_jpeg` on seeded 2x40x40 and 2x37x45 images (edge padding) at
  per-sample qualities 10 and 95, within 1e-4;
- `quality_to_factor` exactly; the wrappers' routing and their refusals;
  the three-plane entry on the CPU against three single-plane calls, bit
  for bit; the kernel's split B fragments of the DCT and the IDCT.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import torch_one_thread  # noqa: F401 (a fixture)

BLOCK_TOL = 1e-3
JPEG_TOL = 1e-4


def _blocks(seed: int = 0):
    rng = np.random.default_rng(seed)
    blocks = (rng.random((2, 100, 64)) * 255 - 128).astype(np.float32)
    qtabs = rng.uniform(1, 50, (2, 64)).astype(np.float32)
    return blocks, qtabs


def test_block_transform_reference_matches_jax():
    from trainner_redux_tpu.ops.pallas.jpeg_kernel import jpeg_block_transform as jax_kernel
    from trainner_redux_tpu.utils.diffjpeg import _dct_matrix, _diff_round, _idct_matrix
    from trainner_redux_tpu_torch.ops import jpeg_kernel

    blocks, qtabs = _blocks()
    tb, tq = torch.from_numpy(blocks), torch.from_numpy(qtabs)
    tied = jpeg_kernel.ties(tb, tq).any(dim=-1).numpy()
    assert tied.sum() == 1
    got = jpeg_kernel.jpeg_block_transform_reference(tb, tq).numpy()

    want_kernel = np.asarray(jax_kernel(jnp.asarray(blocks), jnp.asarray(qtabs), interpret=True))
    coeff = jnp.einsum("uk,bnk->bnu", jnp.asarray(_dct_matrix()), jnp.asarray(blocks))
    qt = jnp.asarray(qtabs)[:, None, :]
    want_einsum = np.asarray(jnp.einsum("uk,bnu->bnk", _idct_matrix(),
                                        _diff_round(coeff / qt) * qt))
    for want in (want_kernel, want_einsum):
        np.testing.assert_allclose(got[~tied], want[~tied], rtol=0, atol=BLOCK_TOL)


def test_block_transform_routes_cpu_tensors_to_the_plain_version():
    from trainner_redux_tpu_torch.ops import jpeg_kernel

    blocks, qtabs = (torch.from_numpy(a) for a in _blocks(1))
    before = jpeg_kernel.jpeg_block_transform.launches
    torch.testing.assert_close(jpeg_kernel.jpeg_block_transform(blocks, qtabs),
                               jpeg_kernel.jpeg_block_transform_reference(blocks, qtabs),
                               rtol=0, atol=0)
    assert jpeg_kernel.jpeg_block_transform.launches == before
    # the plain version keeps the gradient (the card's kernel has none)
    x = blocks.clone().requires_grad_(True)
    jpeg_kernel.jpeg_block_transform(x, qtabs).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_block_transform_matrices_are_row_major():
    """The plain version reads the DCT and the IDCT as row-major (64, 64)
    arrays (the IDCT comes out of numpy column-major); the kernel reads
    both products' B operands (the DCT's B(k, u) = DCT[u, k], the IDCT's
    B(u, k) = IDCT[u, k]) split into TF32 hi and lo by truncation, in
    mma.sync m16n8k8's fragment order: lane 4 g + q of k-step ks and n-tile
    nt holds B(8 ks + q, 8 nt + g) and B(8 ks + q + 4, 8 nt + g)."""
    from trainner_redux_tpu_torch.ops import jpeg_kernel
    from trainner_redux_tpu_torch.utils.diffjpeg import _dct_matrix, _idct_matrix_np

    dct, idct, frags = jpeg_kernel.dct_matrices("cpu")
    assert all(m.is_contiguous() and m.shape == (64, 64) for m in (dct, idct))
    np.testing.assert_array_equal(dct.numpy(), _dct_matrix())
    np.testing.assert_array_equal(idct.numpy(), _idct_matrix_np())
    assert frags.is_contiguous() and frags.shape == (2, 8, 8, 32, 4)
    assert bool(((frags.view(torch.int32) & 0x1FFF) == 0).all())  # TF32 values
    for f, b in zip(frags, (dct.T, idct)):  # B (k, n) of each product
        hi, lo = jpeg_kernel.split_trunc(b)
        for ks, nt, lane in ((0, 0, 0), (3, 5, 13), (7, 7, 31), (6, 1, 22)):
            g, q = lane // 4, lane % 4
            k, n = 8 * ks + q, 8 * nt + g
            assert f[ks, nt, lane].tolist() == [hi[k, n].item(), hi[k + 4, n].item(),
                                                lo[k, n].item(), lo[k + 4, n].item()]
        # every element once: hi + lo back in B's order is B within 2^-20
        whole = (f[..., :2] + f[..., 2:]).double().reshape(8, 8, 8, 4, 2)  # ks nt g q half
        back = whole.permute(0, 4, 3, 1, 2).reshape(64, 64)  # (k, n)
        assert bool(((back - b.double()).abs() <= 2.0**-20 * b.double().abs()).all())


def test_block_transform_planes_on_the_cpu_are_single_plane_calls():
    """The three-plane entry (one launch a compression on the card) runs the
    plain version on each plane on the CPU: bit for bit three single-plane
    calls, with its planes' own block counts and tables, and no launch."""
    from trainner_redux_tpu_torch.ops import jpeg_kernel
    from trainner_redux_tpu_torch.utils.diffjpeg import C_TABLE, Y_TABLE

    rng = np.random.default_rng(3)
    planes = []
    for n, table in ((36, Y_TABLE), (9, C_TABLE), (9, C_TABLE)):
        blocks = (rng.random((2, n, 64)) * 255 - 128).astype(np.float32)
        qtabs = np.clip(table.reshape(1, 64) * np.asarray([[0.5], [1.7]], np.float32), 1, 255)
        planes.append((torch.from_numpy(blocks), torch.from_numpy(qtabs.astype(np.float32))))
    before = jpeg_kernel.jpeg_block_transform.launches
    got = jpeg_kernel.jpeg_block_transform_planes(planes)
    assert jpeg_kernel.jpeg_block_transform.launches == before
    assert len(got) == 3
    for out, (blocks, qtabs) in zip(got, planes):
        assert torch.equal(out, jpeg_kernel.jpeg_block_transform(blocks, qtabs))
    with pytest.raises(ValueError, match="1 to 3 planes"):
        jpeg_kernel.jpeg_block_transform_planes(planes + planes[:1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        jpeg_kernel.jpeg_block_transform_planes(
            [(b.to("meta"), q.to("meta")) for b, q in planes])


def test_block_transform_refuses_other_devices():
    from trainner_redux_tpu_torch.ops import jpeg_kernel

    with pytest.raises(ValueError, match="CUDA tensor"):
        jpeg_kernel.jpeg_block_transform(torch.empty(2, 9, 64, device="meta"),
                                         torch.empty(2, 64, device="meta"))


def test_ties_finds_half_integers():
    from trainner_redux_tpu_torch.ops import jpeg_kernel
    from trainner_redux_tpu_torch.utils.diffjpeg import _idct_matrix_np

    # coefficients 2.5 and -7.5 (and 0 elsewhere) at qtab 1: two ties
    coeff = np.zeros((1, 1, 64), np.float32)
    coeff[0, 0, 3], coeff[0, 0, 17] = 2.5, -7.5
    blocks = torch.from_numpy(coeff @ _idct_matrix_np())
    assert int(jpeg_kernel.ties(blocks, torch.ones(1, 64)).sum()) == 2


@pytest.mark.parametrize("quality", [[10.0, 95.0], 50.0])
def test_quality_to_factor_matches_jax(quality):
    from trainner_redux_tpu.utils.diffjpeg import quality_to_factor as jax_factor
    from trainner_redux_tpu_torch.utils.diffjpeg import quality_to_factor

    q = np.asarray([1.0, 10.0, 49.5, 50.0, 75.0, 95.0, 100.0], np.float32) if quality == 50.0 \
        else np.asarray(quality, np.float32)
    np.testing.assert_array_equal(quality_to_factor(torch.from_numpy(q)).numpy(),
                                  np.asarray(jax_factor(jnp.asarray(q))))


@pytest.mark.parametrize("hw", [(40, 40), (37, 45)])
def test_diff_jpeg_matches_jax(hw):
    from trainner_redux_tpu.utils.diffjpeg import diff_jpeg as jax_diff_jpeg
    from trainner_redux_tpu_torch.utils.diffjpeg import diff_jpeg

    rng = np.random.default_rng(hw[1])
    img = rng.random((2, *hw, 3)).astype(np.float32)
    q = np.asarray([10.0, 95.0], np.float32)
    want = np.asarray(jax_diff_jpeg(jnp.asarray(img), jnp.asarray(q)))
    got = diff_jpeg(torch.from_numpy(img), torch.from_numpy(q)).numpy()
    assert got.shape == img.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=JPEG_TOL)
    # a scalar quality is every sample's
    np.testing.assert_allclose(diff_jpeg(torch.from_numpy(img), 10.0).numpy()[0], got[0],
                               rtol=0, atol=1e-6)
