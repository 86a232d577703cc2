#!/usr/bin/env python3
"""How accurate torch.linalg.eigh is in float32 on the card, by order:
why models/qdwh.py's `_eigh` solves the SVD's h in float64 up to order 512.

    python3 numpywren_tpu_torch/experiments/eigh_f32.py   # with a GPU

PyTorch solves a float32 symmetric matrix of order 32 to 512 on a CUDA
device by cuSOLVER's Jacobi solver (syevj) and a larger one by syevd. For
a symmetric Gaussian (a + aᵀ)/2 of each order (a seeded CUDA generator)
and for QDWH's h of a 512² Gaussian, it prints max |VᵀV − I| and the
residual ||A V − V Λ||_F / ||A||_F of the float32 and of the float64
eigensolve (fp64 arithmetic on the card), one JSON line an order, then the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
ORDERS = (256, 511, 512, 513, 1024)


def quality(a: torch.Tensor, dtype) -> dict:
    s, v = torch.linalg.eigh(a.to(dtype))
    a64, s64, v64 = a.double(), s.double(), v.double()
    eye = torch.eye(a.shape[0], dtype=torch.float64, device=a.device)
    return {"orth_max": float((v64.T @ v64 - eye).abs().max()),
            "residual": float(torch.linalg.norm(a64 @ v64 - v64 * s64) / torch.linalg.norm(a64))}


def main() -> int:
    if not torch.cuda.is_available():
        print("eigh_f32: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from numpywren_tpu_torch.models import qdwh
    from numpywren_tpu_torch.ops import _build

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n in ORDERS:
        a = torch.randn(n, n, generator=gen, device="cuda")
        cases.append((f"symmetric_gaussian_{n}", (a + a.T) / 2))
    _, h, _, _ = qdwh.qdwh(torch.randn(512, 512, generator=gen, device="cuda"))
    cases.append(("qdwh_h_512", h))
    for name, a in cases:
        print(json.dumps({"case": name, "n": a.shape[0], "float32": quality(a, torch.float32),
                          "float64": quality(a, torch.float64)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
