"""Path pairing utilities (parity: the JAX package's data/data_util.py).

Supports folder pairing with filename templates, meta-info files and
multi-root lists. The pack and lmdb pairings come with the training data path.
"""

from __future__ import annotations

from os import path as osp

from trainner_redux_tpu_torch.utils.misc import scandir


def paths_from_folder(folder: str) -> list[str]:
    return [osp.join(folder, p) for p in sorted(scandir(folder, recursive=True))]


def paired_paths_from_folders(
    folders: tuple[list[str], list[str]],
    keys: tuple[str, str],
    filename_tmpl: str = "{}",
) -> list[dict[str, str]]:
    """Pair files across (possibly multiple) input/gt roots by basename.

    folders: ([lq_roots...], [gt_roots...]); keys: ('lq', 'gt').
    The LQ filename is derived from the GT basename via `filename_tmpl`
    (e.g. '{}x4' for DIV2K-style names).
    """
    input_folders, gt_folders = folders
    input_key, gt_key = keys

    # index all input files by filename for O(1) lookup across roots
    input_index: dict[str, str] = {}
    for root in input_folders:
        for rel in scandir(root, recursive=True):
            input_index.setdefault(osp.basename(rel), osp.join(root, rel))

    paths = []
    for gt_root in gt_folders:
        for rel in sorted(scandir(gt_root, recursive=True)):
            gt_path = osp.join(gt_root, rel)
            basename, ext = osp.splitext(osp.basename(rel))
            input_name = f"{filename_tmpl.format(basename)}{ext}"
            input_path = input_index.get(input_name)
            if input_path is None:
                # fall back to identical extension-insensitive match
                for cand_ext in (".png", ".jpg", ".jpeg", ".webp", ".bmp"):
                    input_path = input_index.get(f"{filename_tmpl.format(basename)}{cand_ext}")
                    if input_path:
                        break
            if input_path is None:
                raise FileNotFoundError(
                    f"{input_name} is not in the {input_key} folder(s) {input_folders}"
                )
            paths.append(
                {f"{input_key}_path": input_path, f"{gt_key}_path": gt_path}
            )
    return paths


def paired_paths_from_meta_info_file(
    folders: tuple[list[str], list[str]],
    keys: tuple[str, str],
    meta_info_file: str,
    filename_tmpl: str = "{}",
) -> list[dict[str, str]]:
    """Pair from a meta-info file listing GT names (one per line, first token)."""
    input_folders, gt_folders = folders
    input_key, gt_key = keys
    with open(meta_info_file, encoding="utf-8") as f:
        gt_names = [line.strip().split(" ")[0] for line in f if line.strip()]

    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        gt_path = _find_in_roots(gt_folders, gt_name)
        input_path = _find_in_roots(input_folders, input_name)
        paths.append({f"{input_key}_path": input_path, f"{gt_key}_path": gt_path})
    return paths


def _find_in_roots(roots: list[str], name: str) -> str:
    for root in roots:
        p = osp.join(root, name)
        if osp.exists(p):
            return p
    raise FileNotFoundError(f"{name} not found under any of {roots}")
