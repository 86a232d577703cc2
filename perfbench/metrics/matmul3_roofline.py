"""matmul3_roofline: the matmul3 kernel's share of its roofline over the
traced stretch, in %: the least time the card could take for the matmul3
calls that ran, over the device time of their kernels (the gemm_split
pack and mainloop kernels at two bf16 planes, csrc/gemm_split.cu).

Each call's least time is the larger of its operations over the peak and
its bytes over the memory bandwidth. Operations: 2mnk, the fp32 product's,
against the published dense bf16 peak of one H100 SXM over the three bf16
products that bf16x3 takes. Bytes: a (m x k), b (n x k) and c (m x n) read
once and the result written once, in fp32 (no c: the result alone). The
call shapes are recorded around the kernel's two entries, matmul3 and
Panel.sub_update, while the stretch is traced. These constants stay the
same whatever implements the product.
"""

import contextlib
import re

SOURCE = "device_trace"

PEAK_OPS = 989e12 / 3   # dense bf16 peak of one H100 SXM, over three products
PEAK_BYTES = 3.35e12    # HBM3 bandwidth of one H100 SXM
PLANES = 2              # matmul3's bf16 planes (hi, lo); matmul runs three

_TEMPLATE = re.compile(r"gemm_split_(mainloop|pack_rows|pack_cols)\s*<([^>]*)>")


def planes_of(name: str):
    """The kernel's bf16 planes, from its template arguments (mainloop<P,
    TOut>, pack_*<TIn, P>), or None for another kernel."""
    m = _TEMPLATE.search(name)
    if not m:
        return None
    args = [a.strip() for a in m.group(2).split(",")]
    try:
        return int(args[0] if m.group(1) == "mainloop" else args[1])
    except (IndexError, ValueError):
        return None


def least_seconds(m: int, n: int, k: int, with_c: bool) -> float:
    ops = 2.0 * m * n * k
    nbytes = 4.0 * (m * k + n * k + (2 if with_c else 1) * m * n)
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


@contextlib.contextmanager
def instrument():
    """Record (m, n, k, with_c) of every matmul3 kernel call and panel
    update while the context is open."""
    from numpywren_tpu_torch.ops import gemm3

    calls = []
    split, sub = gemm3._split_launch, gemm3.Panel.sub_update

    def split_rec(a, b, c, out, ta, tb, alpha, beta, m, n, k, planes):
        calls.append((m, n, k, c is not None))
        return split(a, b, c, out, ta, tb, alpha, beta, m, n, k, planes)

    def sub_rec(self, c, off, n, *, out=None):
        if self.planes is not None:
            calls.append((self.rows - off, n, self.k, True))
        return sub(self, c, off, n, out=out)

    gemm3._split_launch, gemm3.Panel.sub_update = split_rec, sub_rec
    try:
        yield calls
    finally:
        gemm3._split_launch, gemm3.Panel.sub_update = split, sub


def read(ctx, rec=None):
    if not rec:
        return None
    device_ns = sum(e - s for name, s, e in ctx.device if planes_of(name) == PLANES)
    if device_ns <= 0:
        return None
    return 100.0 * sum(least_seconds(*c) for c in rec) / (device_ns / 1e9)
