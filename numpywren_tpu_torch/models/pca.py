"""Principal component analysis on the randomized/tall SVD paths.

Counterpart of numpywren_tpu/models/pca.py: center (one pass, on the
data's device, the mean summed in fp64), then the thin SVD of the centered
data (`svd_tall`) or its randomized sketch (`randomized_svd`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from numpywren_tpu_torch.ops.common import as_tensor

__all__ = ["pca"]


def pca(x, n_components: int, center: bool = True,
        method: str = "auto", seed: int = 0,
        device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Top `n_components` principal components of the (n_samples, n_features)
    data matrix x (a tensor stays where it is, an ndarray goes to `device`,
    else the current CUDA device).

    Returns ndarrays (components, explained_variance, scores):
    components (n_components, n_features) — rows are principal axes;
    explained_variance (n_components,) — sigma² / (n_samples - 1);
    scores (n_samples, n_components) — the data projected onto the axes.

    method: "auto" picks "tall" (exact thin SVD via CholeskyQR,
    models.svd_tall) when n_features <= 2048 and n_samples >= n_features,
    else "randomized" (models.randomized_svd, seeded by `seed`)."""
    from numpywren_tpu_torch.models.svd import randomized_svd, svd_tall

    xd = as_tensor(x, device)
    if xd.dim() != 2:
        raise ValueError(f"pca expects 2-D data, got shape {tuple(xd.shape)}")
    m, n = xd.shape
    if not 1 <= n_components <= min(m, n):
        raise ValueError(f"n_components {n_components} out of range for {tuple(xd.shape)}")
    if center:
        xd = xd - xd.mean(dim=0, keepdim=True, dtype=torch.float64).to(xd.dtype)
    if method == "auto":
        method = "tall" if (n <= 2048 and m >= n) else "randomized"
    if method == "tall":
        u, s, vt = svd_tall(xd)
        u, s, vt = u[:, :n_components], s[:n_components], vt[:n_components]
    elif method == "randomized":
        u, s, vt = randomized_svd(xd, rank=n_components, seed=seed)
    else:
        raise ValueError(f"unknown method {method!r}")
    explained = (s.astype(np.float64) ** 2 / max(m - 1, 1)).astype(s.dtype)
    scores = u * s
    return vt, explained, scores
