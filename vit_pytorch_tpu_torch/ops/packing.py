"""NaViT variable-resolution sequence packing, port of
``vit_pytorch_tpu/ops/packing.py``.

The host side is the JAX package's numpy code unchanged: greedy grouping of
images into packs bounded by ``max_seq_len`` (the behaviour of reference
na_vit.py:38-77), channel-first patch flattening, token dropout drawn from
the caller's ``np.random.Generator``, and assembly into fixed-shape arrays.
Only the last step differs: the arrays become torch tensors on the device
the caller names.  The block-diagonal mask never materializes on the kernel
path: the segment ids feed the flash kernels, which skip cross-segment
tiles (``ops/flash_attention.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..utils.helpers import default_device


@dataclass
class PackedImages:
    """Fixed-shape packed batch.  b = number of groups.

    patches:     (b, L, patch_dim) float — flattened patch pixels, zero-padded
    pos_hw:      (b, L, 2) int32 — (h, w) patch grid coordinates
    image_ids:   (b, L) int32 — segment id per token, -1 for padding
    num_images:  (b,) int32 — real images per group
    max_images:  int — query count for attention pooling
    """

    patches: torch.Tensor
    pos_hw: torch.Tensor
    image_ids: torch.Tensor
    num_images: torch.Tensor
    max_images: int

    @property
    def is_image(self) -> torch.Tensor:
        """(b, max_images) bool — which pooled outputs are real images."""
        ar = torch.arange(self.max_images, device=self.num_images.device)
        return ar[None, :] < self.num_images[:, None]

    @property
    def device(self) -> torch.device:
        return self.patches.device

    def to(self, device=None, dtype=None) -> "PackedImages":
        """The batch on ``device``, with ``patches`` cast to ``dtype``."""
        return PackedImages(
            self.patches.to(device=device, dtype=dtype), self.pos_hw.to(device), self.image_ids.to(device),
            self.num_images.to(device), self.max_images,
        )


def _as_numpy(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return np.asarray(img)


def group_images_by_max_seq_len(
    images: Sequence,
    patch_size: int,
    calc_token_dropout: Optional[Union[float, Callable]] = None,
    max_seq_len: int = 2048,
) -> List[List]:
    """Greedy first-fit grouping (behaviour of reference na_vit.py:38-77)."""
    if calc_token_dropout is None:
        calc_token_dropout = lambda h, w: 0.0
    elif isinstance(calc_token_dropout, (float, int)):
        p = float(calc_token_dropout)
        calc_token_dropout = lambda h, w: p

    groups: List[List] = []
    group: List = []
    seq_len = 0

    for image in images:
        h, w = _as_numpy(image).shape[-2:]
        ph, pw = h // patch_size, w // patch_size
        # max(1, ...) mirrors pack_images' num_keep so the greedy budget can
        # never under-count an image the packer will keep 1 token for
        image_seq_len = max(1, int((ph * pw) * (1 - calc_token_dropout(h, w))))
        assert image_seq_len <= max_seq_len, f"image with dimensions {(h, w)} exceeds maximum sequence length"
        if seq_len + image_seq_len > max_seq_len:
            groups.append(group)
            group = []
            seq_len = 0
        group.append(image)
        seq_len += image_seq_len

    if group:
        groups.append(group)
    return groups


def pack_images(
    images: Sequence,
    patch_size: int,
    *,
    group_images: bool = True,
    max_seq_len: int = 2048,
    token_dropout_prob: Optional[Union[float, Callable]] = None,
    train: bool = False,
    rng: Optional[np.random.Generator] = None,
    pad_groups_to: Optional[int] = None,
    max_images: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> PackedImages:
    """Pack a list of (c, H, W) images (numpy arrays or tensors; or a list of
    lists, pre-grouped) into fixed-shape tensors on ``device`` (the CUDA card
    unless it names another), ``patches`` in ``dtype``.  The JAX
    ``pack_images`` (packing.py:99-213) step for step: ``rng=None`` draws OS
    entropy for the token dropout; pass an
    ``np.random.Generator`` for reproducible packing."""
    device = default_device(device)
    use_dropout = train and token_dropout_prob is not None
    calc_dropout = token_dropout_prob
    if isinstance(calc_dropout, (float, int)):
        p_drop = float(calc_dropout)
        calc_dropout = lambda h, w: p_drop
    if rng is None:
        rng = np.random.default_rng()

    first = images[0]
    is_grouped = isinstance(first, (list, tuple))
    if group_images and not is_grouped:
        groups = group_images_by_max_seq_len(
            images,
            patch_size,
            calc_token_dropout=token_dropout_prob if train else None,
            max_seq_len=max_seq_len,
        )
    elif not is_grouped:
        groups = [list(images)]
    else:
        groups = [list(g) for g in images]

    p = patch_size
    b = len(groups)
    b_out = max(b, pad_groups_to or 0)

    patch_dim = None
    all_patches, all_pos, all_ids, n_imgs = [], [], [], []

    for images_in_group in groups:
        seqs, poss, ids = [], [], []
        for idx, image in enumerate(images_in_group):
            arr = _as_numpy(image)
            c, h, w = arr.shape
            assert h % p == 0 and w % p == 0, f"height and width {(h, w)} must be divisible by patch size {p}"
            ph, pw = h // p, w // p
            # (c, ph, p, pw, p) -> (ph*pw, c*p*p): channel-first flattening,
            # matching reference 'c (h p1) (w p2) -> (h w) (c p1 p2)'
            # (na_vit.py:300)
            patches = arr.reshape(c, ph, p, pw, p).transpose(1, 3, 0, 2, 4).reshape(ph * pw, c * p * p)
            hh, ww = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
            pos = np.stack([hh.ravel(), ww.ravel()], axis=-1)

            if use_dropout:
                n = patches.shape[0]
                num_keep = max(1, int(n * (1 - calc_dropout(h, w))))
                keep = rng.permutation(n)[:num_keep]
                patches, pos = patches[keep], pos[keep]

            seqs.append(patches)
            poss.append(pos)
            ids.append(np.full(patches.shape[0], idx, dtype=np.int32))
            patch_dim = patches.shape[-1]

        all_patches.append(np.concatenate(seqs, axis=0))
        all_pos.append(np.concatenate(poss, axis=0))
        all_ids.append(np.concatenate(ids, axis=0))
        n_imgs.append(len(images_in_group))

    L = max_seq_len
    max_len = max(x.shape[0] for x in all_patches)
    assert max_len <= L, f"packed length {max_len} exceeds max_seq_len {L}"

    n_q = max_images if max_images is not None else max(n_imgs)

    patches_out = np.zeros((b_out, L, patch_dim), dtype=np.float32)
    pos_out = np.zeros((b_out, L, 2), dtype=np.int32)
    ids_out = np.full((b_out, L), -1, dtype=np.int32)
    n_out = np.zeros((b_out,), dtype=np.int32)

    for i in range(b):
        n = all_patches[i].shape[0]
        patches_out[i, :n] = all_patches[i]
        pos_out[i, :n] = all_pos[i]
        ids_out[i, :n] = all_ids[i]
        n_out[i] = n_imgs[i]

    return PackedImages(
        patches=torch.from_numpy(patches_out).to(device=device, dtype=dtype),
        pos_hw=torch.from_numpy(pos_out).to(device),
        image_ids=torch.from_numpy(ids_out).to(device),
        num_images=torch.from_numpy(n_out).to(device),
        max_images=int(n_q),
    )
