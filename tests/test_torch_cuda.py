"""The CUDA kernels against their plain PyTorch versions on the card. GEMM
kernels at small and awkward shapes: ragged edges, K not a multiple of 8,
K = 0, one row or column, transposed and strided operands, bf16, and out
aliasing c. Factor kernels at n = 128..1024 and outside their envelope;
the CholeskyQR2 chain in both forms at κ up to 1e6, its identity branch
and its run with no host synchronisation. The paths on them against their
CPU runs: the generic executors, the out-of-core Cholesky, the models, the
fused BDFAC by every route, the band reduction, QDWH and the out-of-core
BDFAC.

These need an NVIDIA GPU (sm_90a) and nvcc; without one every test skips.
Run on the card: python -m pytest tests/test_torch_cuda.py -q

Tolerance: relative Frobenius error 1e-5, both sides doing the same fp32
(or bf16x3) arithmetic in another summation order; 1e-6 against the GEMM
kernels' own arithmetic (_matmul_split_ref), which differs only by the
tensor cores' truncating sums inside a 64-deep slice; the chain's own bars
are in its test.
"""

import importlib
import pytest
import torch

from numpywren_tpu_torch.ops import gemm3

# the module: the package exports its function `gemm` under the same name
gemm = importlib.import_module("numpywren_tpu_torch.ops.gemm")

BAR = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def _close(got, want, bar=BAR):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    den = torch.linalg.norm(want.float())
    err = torch.linalg.norm((got - want).float())
    assert err <= bar * den if den > 0 else err == 0


SHAPES = [(1, 1, 1), (1, 130, 7), (129, 1, 3), (130, 70, 9), (200, 257, 0), (256, 128, 128),
          (1000, 777, 300)]


@pytest.mark.parametrize("with_c", [False, True])
@pytest.mark.parametrize("tb", [False, True])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_matmul3_kernel(gen, m, n, k, tb, with_c):
    """gemm_split.cu at two planes: against matmul3_ref (1e-5) and its own
    arithmetic, _matmul_split_ref at P = 2 (1e-6); three device launches."""
    a = _rand(gen, m, k)
    b = _rand(gen, n, k) if tb else _rand(gen, k, n)
    c = _rand(gen, m, n) if with_c else None
    before, device_before = gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES
    got = gemm3.matmul3(a, b, c, tb=tb)
    assert gemm3.LAUNCHES == before + 1
    assert gemm3.DEVICE_LAUNCHES == device_before + 3  # pack A, pack B, mainloop
    _close(got, gemm3.matmul3_ref(a, b, c, tb=tb))
    kw = dict(alpha=-1.0, beta=1.0) if with_c else {}
    _close(got, gemm._matmul_split_ref(a, b, c, tb=tb, planes=2, **kw), bar=1e-6)


@pytest.mark.parametrize("layout", ["contiguous", "trapezoid", "flat"])
def test_matmul3_panel_route_is_the_per_call_route(gen, layout):
    """A panel packed once, then updates at several offsets (the last one
    ragged): the same bits as matmul3 per call, one device launch an
    update, one for the pack; the panel is read, never written."""
    rows, w = 1000, 200
    if layout == "contiguous":
        b = _rand(gen, rows, w)
    elif layout == "trapezoid":  # a column block's rows below its diagonal block
        b = _rand(gen, w + rows, w)[w:]
    else:  # columns of one flat padded matrix
        b = _rand(gen, rows, 3 * w)[:, w:2 * w]
    keep = b.clone()
    before, device_before = gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES
    panel = gemm3.Panel(b)
    assert (gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES) == (before, device_before + 1)
    for off, n in ((0, w), (w, w), (300, 77), (4 * w, w), (rows - 1, 1)):
        c = _rand(gen, rows - off, n)
        want = gemm3.matmul3(b[off:], b[off:off + n], c, tb=True)
        before, device_before = gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES
        got = panel.sub_update(c, off, n, out=c)
        assert got is c
        assert (gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES) == (before + 1, device_before + 1)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (layout, off, n)
    assert torch.equal(b, keep)


def test_compensated_cholesky_panel_route_is_the_per_call_route(gen, monkeypatch):
    """One compensated factorization with each panel packed once, and the
    same with every update as its own matmul3 call: the same bits, and
    the launch counts the two routes imply."""
    from numpywren_tpu_torch import config as pconfig
    from numpywren_tpu_torch.compiler import lower
    from numpywren_tpu_torch.trapezoid import TrapezoidMatrix, cholesky_trapezoid

    monkeypatch.setattr(pconfig, "_default", pconfig.NpwConfig(compensated=True))
    n, panel = 1280, 256  # five panels; 128-wide leaves, three products a panel's solve
    x = _rand(gen, n, n)
    a = x @ x.T / n + 2 * torch.eye(n, device="cuda")

    class PerCall:  # the per-call route behind the Panel interface
        def __init__(self, b):
            self.b = b

        def sub_update(self, c, off, n, out=None):
            return gemm3.matmul3(self.b[off:], self.b[off:off + n], c, tb=True, out=out)

    results = {}
    for route in ("panel", "per_call"):
        if route == "per_call":
            monkeypatch.setattr(lower, "Panel", PerCall)
        gemm3.LAUNCHES = gemm3.DEVICE_LAUNCHES = 0
        results[route] = (cholesky_trapezoid(TrapezoidMatrix.from_array(a, panel=panel)).numpy(),
                          gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES)
    nb, products = n // panel, 3
    updates = nb * (nb - 1) // 2
    calls = (nb - 1) * products + updates
    assert results["panel"][1:] == (calls, 3 * (nb - 1) * products + (nb - 1) + updates)
    assert results["per_call"][1:] == (calls, 3 * calls)
    assert (results["panel"][0] == results["per_call"][0]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True), (True, False), (True, True)])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_matmul_kernel(gen, m, n, k, ta, tb, dtype):
    a = _rand(gen, *((k, m) if ta else (m, k)), dtype=dtype)
    b = _rand(gen, *((n, k) if tb else (k, n)), dtype=dtype)
    c = _rand(gen, m, n)
    kw = dict(ta=ta, tb=tb, alpha=0.5, beta=-2.0, out_dtype=torch.float32)
    before, device_before = gemm.LAUNCHES, gemm.DEVICE_LAUNCHES
    got = gemm.matmul(a, b, c, precision="highest", **kw)
    assert gemm.LAUNCHES == before + 1
    assert gemm.DEVICE_LAUNCHES == device_before + 3  # pack A, pack B, mainloop
    _close(got, gemm.matmul_ref(a, b, c, **kw))
    _close(got, gemm._matmul_split_ref(a, b, c, **kw))


def test_bf16_output_and_c_of_another_dtype(gen):
    a, b = _rand(gen, 300, 200, dtype=torch.bfloat16), _rand(gen, 200, 100, dtype=torch.bfloat16)
    c = _rand(gen, 300, 100)
    got = gemm.matmul(a, b, c, precision="default")  # bf16 out, fp32 c
    assert got.dtype == torch.bfloat16
    want = gemm.matmul_ref(a, b, c)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)  # bf16 rounding


@pytest.mark.parametrize("kernel", ["matmul", "matmul3"])
def test_strided_views_in_place(gen, kernel):
    """The trailing update's form: row-strided column views of one buffer,
    the result written into c where it lies; nothing else changes."""
    buf = _rand(gen, 700, 3 * 128)  # every view below has leading dimension 384
    a, b, c = buf[:, :128], buf[:128, 128:256], buf[:, 256:]
    want = gemm3.matmul3_ref(a, b, c, tb=True) if kernel == "matmul3" else c - a @ b.T
    keep = buf[:, :256].clone()
    if kernel == "matmul3":
        out = gemm3.matmul3(a, b, c, tb=True, out=c)
    else:
        out = gemm.matmul(a, b, c, tb=True, alpha=-1.0, beta=1.0, precision="highest", out=c)
    assert out.data_ptr() == c.data_ptr()
    _close(c, want)
    assert torch.equal(buf[:, :256], keep)


@pytest.mark.parametrize("m,n,k", [(129, 257, 1000), (1000, 777, 300), (4096, 1024, 1024)])
def test_matmul_kernel_against_its_split_arithmetic(gen, m, n, k):
    """Ragged and trailing-update shapes, c - a bᵀ as the Cholesky runs it:
    the kernel against _matmul_split_ref (its own arithmetic) and matmul_ref
    (fp32), and its error against fp64 within 2x of matmul_ref's (cuBLAS
    in true FP32)."""
    a, b, c = _rand(gen, m, k), _rand(gen, n, k), _rand(gen, m, n)
    kw = dict(tb=True, alpha=-1.0, beta=1.0)
    got = gemm.matmul(a, b, c, precision="highest", **kw)
    _close(got, gemm._matmul_split_ref(a, b, c, **kw))
    ref = gemm.matmul_ref(a, b, c, **kw)
    _close(got, ref)
    exact = c.double() - a.double() @ b.double().T

    def err(x):
        return torch.linalg.norm(x.double() - exact) / torch.linalg.norm(exact)

    assert err(got) <= 2 * err(ref)


def test_matmul_bf16_out_from_fp32(gen):
    """fp32 operands (three planes), bf16 c and out: the kernel reads c and
    writes out in bf16, rounded to nearest from its fp32 epilogue."""
    a, b, c = _rand(gen, 300, 200), _rand(gen, 100, 200), _rand(gen, 300, 100)
    c16 = c.to(torch.bfloat16)
    got = gemm.matmul(a, b, c16, tb=True, alpha=-1.0, beta=1.0, out_dtype=torch.bfloat16,
                      precision="highest")
    assert got.dtype == torch.bfloat16
    want = gemm.matmul_ref(a, b, c16, tb=True, alpha=-1.0, beta=1.0, out_dtype=torch.float32)
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)  # bf16 rounding


def test_matmul_kernel_same_bits_on_two_streams(gen):
    """No atomics and no order that depends on timing: the same call on two
    streams gives the same bits."""
    a, b, c = _rand(gen, 1000, 512), _rand(gen, 640, 512), _rand(gen, 1000, 640)
    outs = []
    for _ in range(2):
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            outs.append(gemm.matmul(a, b, c, tb=True, alpha=-1.0, beta=1.0,
                                    precision="highest"))
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])


def test_matmul_split_plan():
    """The ring the mainloop runs: 64-deep slices, two stages of six 16 KB
    tiles at three planes, three of four at two (matmul3), six of two at
    one; all within 227 KB a CTA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plans = {p: gemm.split_plan(p) for p in (1, 2, 3)}
    assert all(plan["slice"] == gemm.SLICE for plan in plans.values())
    assert [plans[p]["stages"] for p in (1, 2, 3)] == [6, 3, 2]
    for p, plan in plans.items():
        assert plan["stages"] * 2 * p * 16384 <= plan["smem_bytes"] <= 232448
    assert plans[2]["smem_bytes"] == 197680
    with pytest.raises(RuntimeError):
        gemm.split_plan(4)


def test_non_unit_column_stride_is_copied(gen):
    a = _rand(gen, 64, 96)[:, ::2]  # column stride 2: the wrapper makes it contiguous
    b = _rand(gen, 40, 48)
    _close(gemm3.matmul3(a, b, tb=True), gemm3.matmul3_ref(a, b, tb=True))
    _close(gemm.matmul(a, b, tb=True, precision="highest"), gemm.matmul_ref(a, b, tb=True))


def test_wrong_dtype_raises(gen):
    a = _rand(gen, 8, 8).double()
    with pytest.raises(TypeError):
        gemm3.matmul3(a, a)
    with pytest.raises(TypeError):
        gemm.matmul(a, a, precision="highest")


# ---------------------------------------------------------------------------
# The factor kernels and the CholeskyQR2 chain (ops/pallas_factor.py)
# ---------------------------------------------------------------------------

def _spd(gen, n):
    x = _rand(gen, n, n)
    return x @ x.T / n + torch.eye(n, device="cuda")


@pytest.mark.parametrize("n", [128, 256, 384, 512, 640, 1024])
def test_factor_kernels(gen, n):
    """potrf (csrc/potrf.cu's launch sequence), potrf_inv (the same sequence
    and csrc/trtri.cu's levels), trtri (csrc/trtri.cu), trsm against their
    plain versions: the same fp32 algorithm in another blocking and
    summation order (rel 1e-5); strict upper triangles exactly 0; one
    counted launch per wrapper call, and the sequences' device launches
    (potrf 4 n/128 - 3, trtri 1 + 2 ceil(log2(n/128)), potrf_inv both);
    L W = I to 1e-4."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _spd(gen, n)
    before = dict(pf.LAUNCHES)
    device_before = dict(pf.DEVICE_LAUNCHES)
    l = pf.potrf_pallas(a)
    l2, w = pf.potrf_inv_pallas(a)
    wi = pf.trtri_pallas(l)
    for kind in ("potrf", "potrf_inv", "trtri"):
        assert (pf.DEVICE_LAUNCHES[kind]
                == device_before[kind] + pf.device_launches(kind, n)), kind
    x = _rand(gen, 300, n)
    s = pf.trsm_pallas(x, l, precision="highest")
    assert pf.LAUNCHES["potrf"] == before["potrf"] + 1
    assert pf.LAUNCHES["potrf_inv"] == before["potrf_inv"] + 1
    assert pf.LAUNCHES["trtri"] == before["trtri"] + 2
    lr, wr = pf.potrf_inv_ref(a)
    _close(l, pf.potrf_ref(a))
    _close(l2, lr)
    _close(w, wr)
    _close(wi, pf.trtri_ref(l))
    _close(s, x @ pf.trtri_ref(l).T)
    eye = torch.eye(n, device="cuda")
    for m in (l, l2, w, wi):
        assert torch.count_nonzero(torch.triu(m, 1)) == 0
    assert float((l2 @ w - eye).abs().max()) <= 1e-4
    assert float((l @ wi - eye).abs().max()) <= 1e-4


def _spd_kappa(gen, n, kappa):
    q, _ = torch.linalg.qr(_rand(gen, n, n).double())
    ev = torch.logspace(0, -torch.log10(torch.tensor(kappa)).item(), n, device="cuda",
                        dtype=torch.float64)
    return ((q * ev) @ q.T).float()


def test_potrf_kernel_kappa_nonspd_and_streams(gen):
    """κ = 1e5: ‖A − LLᵀ‖_F/‖A‖_F ≤ 1e-5 (fp64). A non-SPD tile gives
    non-finite values and no exception. Two calls on two streams agree
    bit for bit (the scratch is per call)."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _spd_kappa(gen, 1024, 1e5)
    l = pf.potrf_pallas(a).double()
    a64 = a.double()
    assert float(torch.linalg.norm(a64 - l @ l.T) / torch.linalg.norm(a64)) <= 1e-5
    bad = _spd(gen, 512)
    bad[300, 300] = -1.0
    out = pf.potrf_pallas(bad)
    torch.cuda.synchronize()
    assert not bool(torch.isfinite(out).all())
    a = _spd(gen, 1024)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            outs.append(pf.potrf_pallas(a))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    _close(outs[0], pf.potrf_ref(a))


@pytest.mark.parametrize("kappa", [10.0, 1e4])
def test_potrf_diag_step(gen, kappa):
    """The diagonal step alone against _factor_block_rec_ref: rel 1e-5 on L
    and W at κ = 10. At κ = 1e4 two summation orders differ by ~κ·eps in
    L's last columns, so the kernel is held by ‖D − LLᵀ‖_F/‖D‖_F ≤ 1e-5
    (fp64) and ‖LW − I‖_max ≤ 1e-4. Strict upper triangles exactly 0."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    d = _spd_kappa(gen, 128, kappa)
    before = pf.LAUNCHES["potrf_diag"]
    l, w = pf.potrf_diag_block(d)
    assert pf.LAUNCHES["potrf_diag"] == before + 1
    if kappa == 10.0:
        lr, wr = pf._factor_block_rec_ref(d)
        _close(l, lr)
        _close(w, wr)
    l64, d64 = l.double(), d.double()
    assert float(torch.linalg.norm(d64 - l64 @ l64.T) / torch.linalg.norm(d64)) <= 1e-5
    assert float((l64 @ w.double() - torch.eye(128, device="cuda", dtype=torch.float64))
                 .abs().max()) <= 1e-4
    for m in (l, w):
        assert torch.count_nonzero(torch.triu(m, 1)) == 0


@pytest.mark.parametrize("n", [384, 1024])
def test_inverse_kernels_on_a_side_stream(gen, n):
    """trtri and potrf_inv enqueue on the caller's stream: on a new
    torch.cuda.Stream they give the same bits as on the default stream."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _spd(gen, n)
    l = pf.potrf_pallas(a)
    want = pf.trtri_pallas(l), *pf.potrf_inv_pallas(a)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = pf.trtri_pallas(l), *pf.potrf_inv_pallas(a)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_factor_envelope_fallback_does_not_launch(gen):
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _spd(gen, 200)
    before = dict(pf.LAUNCHES)
    l, w = pf.potrf_inv_pallas(a)
    pf.potrf_pallas(a)
    pf.trtri_pallas(l)
    assert pf.LAUNCHES == before
    assert float((l @ w - torch.eye(200, device="cuda")).abs().max()) <= 1e-4


def _panel(gen, m, b, kappa):
    u, _ = torch.linalg.qr(_rand(gen, m, b))
    v, _ = torch.linalg.qr(_rand(gen, b, b))
    s = torch.logspace(0, -torch.log10(torch.tensor(kappa)).item(), b, device="cuda")
    return (u * s) @ v.T


@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("b,kappa", [(128, 10.0), (256, 10.0), (256, 1e4), (256, 1e6)])
def test_cholqr2_chain_kernel(gen, b, kappa, rows):
    """The chain against its plain versions: against cholqr2_chain_ref (fp32
    throughout) q to 3e-5 (max abs), total to rel 1e-5, the same conv flag,
    dev2 to rel 1e-4 (two summation orders); against
    _cholqr2_chain_steps_ref (the sequence's own arithmetic, the apply at
    three bf16 planes) the same, and q to rel 1e-5 at kappa = 10. One call
    enqueues device_launches("cholqr2_chain", b) device launches."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    p = _panel(gen, 4096, b, kappa)
    if rows:
        p = p.T.contiguous()
    g = p @ p.T if rows else p.T @ p
    kw = dict(rows=rows, shift_c=4.0 * 1.1920929e-07 * (4096 * b) ** 0.5, conv_gate=0.02)
    before = pf.LAUNCHES["cholqr2_chain"]
    device_before = pf.DEVICE_LAUNCHES["cholqr2_chain"]
    q, total, conv, dev2 = pf.cholqr2_chain_pallas(g, p, **kw)
    assert pf.LAUNCHES["cholqr2_chain"] == before + 1
    assert (pf.DEVICE_LAUNCHES["cholqr2_chain"]
            == device_before + pf.device_launches("cholqr2_chain", b))
    for plain in (pf.cholqr2_chain_ref, pf._cholqr2_chain_steps_ref):
        qr, tr, convr, dev2r = plain(g, p, **kw)
        torch.cuda.synchronize()
        assert float((q - qr).abs().max()) <= 3e-5
        _close(total, tr)
        assert bool(conv) == bool(convr)
        assert abs(float(dev2) - float(dev2r)) <= 1e-4 * float(dev2r)
    if kappa == 10.0:
        _close(q, qr)
    with pytest.raises(ValueError):
        pf.cholqr2_chain_pallas(g, p[:, :100] if rows else p[:100], **kw)


@pytest.mark.parametrize("rows", [False, True])
def test_cholqr2_chain_identity_branch(gen, rows):
    """dev2 >= 0.1 (a shift as large as the Gram's row sums): the select
    makes the fold the identity, so every output is finite, conv is False
    and R is the shifted factor, as in the sequence's plain version."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    p = _panel(gen, 4096, 256, 10.0)
    if rows:
        p = p.T.contiguous()
    g = p @ p.T if rows else p.T @ p
    kw = dict(rows=rows, shift_c=1.0, conv_gate=0.02)
    q, total, conv, dev2 = pf.cholqr2_chain_pallas(g, p, **kw)
    qs, ts, _, dev2s = pf._cholqr2_chain_steps_ref(g, p, **kw)
    torch.cuda.synchronize()
    for x in (q, total, dev2):
        assert bool(torch.isfinite(x).all())
    assert float(dev2) >= 0.1 and not bool(conv)
    _close(q, qs)
    _close(total, ts)
    assert abs(float(dev2) - float(dev2s)) <= 1e-4 * float(dev2s)


@pytest.mark.parametrize("b", [128, 256])
@pytest.mark.parametrize("rows", [False, True])
def test_cholqr2_chain_failed_factor(gen, rows, b):
    """g with its last diagonal entry negated: the factor's last pivot is
    negative, so E2 holds NaN. dev2 is NaN (the parts' max carries it),
    conv False and the fold the identity, as in the sequence's plain
    version: R's NaN is its failed row (rows) or column (columns) alone."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    p = _panel(gen, 4096, b, 10.0)
    if rows:
        p = p.T.contiguous()
    g = p @ p.T if rows else p.T @ p
    g[-1, -1] = -g[-1, -1]
    kw = dict(rows=rows, shift_c=4.0 * 1.1920929e-07 * (4096 * b) ** 0.5, conv_gate=0.02)
    q, total, conv, dev2 = pf.cholqr2_chain_pallas(g, p, **kw)
    _, ts, _, _ = pf._cholqr2_chain_steps_ref(g, p, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isnan(dev2)) and not bool(conv)
    failed = torch.isnan(ts)
    assert int(failed.sum()) == b
    assert torch.equal(torch.isnan(total), failed)
    _close(total[~failed], ts[~failed])


def test_cholqr2_chain_has_no_host_synchronisation(gen):
    """The whole sequence is enqueued with no host read: the call runs
    under torch's sync debug mode set to raise on a synchronising op."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    p = _panel(gen, 4096, 256, 10.0)
    g = p.T @ p
    kw = dict(rows=False, shift_c=4.0 * 1.1920929e-07 * (4096 * 256) ** 0.5, conv_gate=0.02)
    pf.cholqr2_chain_pallas(g, p, **kw)  # builds and sets up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        q, total, conv, dev2 = pf.cholqr2_chain_pallas(g, p, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _close(q, pf.cholqr2_chain_ref(g, p, **kw)[0])


# ---------------------------------------------------------------------------
# The blocked-Householder QR kernel and the generic executors on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(128, 128), (256, 128), (384, 256), (512, 512), (2048, 128)])
def test_qr_kernel(gen, m, n):
    """The qr kernel against qr_ref: rel 1e-5 on Q and R (the same fp32
    steps in another summation order), ‖QᵀQ − I‖_max ≤ 2e-5, R exactly
    upper triangular."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _rand(gen, m, n)
    before = pf.LAUNCHES["qr"]
    q, r = pf.qr_pallas(a)
    assert pf.LAUNCHES["qr"] == before + 1
    qr_, rr = pf.qr_ref(a)
    _close(q, qr_)
    _close(r, rr)
    assert torch.equal(torch.triu(r), r)
    assert float((q.T @ q - torch.eye(n, device="cuda")).abs().max()) <= 2e-5
    qs, rs = pf._qr_rowsplit_ref(a, pf._qr_parts(m))  # the kernel's own sum order
    _close(q, qs)
    _close(r, rs)


def test_qr_kernel_zero_column_and_kappa(gen):
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _rand(gen, 512, 128)
    a[:, 7] = 0.0
    q, r = pf.qr_pallas(a)
    assert torch.isfinite(q).all() and torch.isfinite(r).all()
    _close(q @ r, a)
    p = _panel(gen, 512, 128, 1e7)
    q, r = pf.qr_pallas(p)
    assert float((q.T @ q - torch.eye(128, device="cuda")).abs().max()) <= 5e-5
    assert float((q @ r - p).abs().max()) <= 1e-5 * float(p.abs().max())


def test_qr_kernel_streams(gen):
    """Two calls on two streams agree bit for bit (the scratch is per
    call; the cooperative launch takes the caller's stream), and the plan
    fits one CTA per SM."""
    from numpywren_tpu_torch.ops import pallas_factor as pf

    a = _rand(gen, 2048, 128)
    plan = pf.qr_plan(2048, 128)
    assert plan["parts"] == 16 and plan["smem_bytes"] <= 232448
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    torch.cuda.synchronize()
    for s in streams:
        with torch.cuda.stream(s):
            outs.append(pf.qr_pallas(a))
    torch.cuda.synchronize()
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    _close(outs[0][0], pf.qr_ref(a)[0])


def test_qr_off_envelope_does_not_launch(gen):
    from numpywren_tpu_torch.ops import pallas_factor as pf

    before = dict(pf.LAUNCHES)
    for shape in ((100, 60), (128, 256), (4096, 128)):
        a = _rand(gen, *shape)
        q, r = pf.qr_pallas(a)
        _close(q @ r, a)
    assert pf.LAUNCHES == before


@pytest.mark.parametrize("executor,storage", [("jax", "hbm"), ("spill", "host"),
                                              ("local", "host")])
def test_generic_executors_on_the_card(gen, executor, storage):
    import numpywren_tpu_torch as npw
    from numpywren_tpu_torch.runtime.program import PS

    a = _spd(gen, 512)
    prog, o, _ = npw.cholesky(a, tile=(128, 128), storage=storage)
    assert o.device.type == "cuda"
    assert npw.run_program(prog, executor=executor) == PS.SUCCESS
    l = o.to_hbm().array if storage == "host" else o.array
    _close(l @ l.T, a)


@pytest.mark.parametrize("width", [1, 2])
def test_out_of_core_cholesky_on_the_card(gen, monkeypatch, width):
    """The out-of-core Cholesky at n = 2048 (tile 128, W = 512),
    compensated: every trailing update a matmul3 call on the card (three
    device launches), uploads and downloads on their own streams, and the
    factor within 1e-5 (relative Frobenius) of the CPU run of the same
    input (the plain bf16x3 version)."""
    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.runtime import out_of_core_cholesky

    monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=True))
    a = _spd(gen, 2048)
    x = shard_matrix(a, tile=(128, 128), storage="host", symmetric=True)
    assert x.device.type == "cuda" and x.get_block(3, 1).is_pinned()
    calls, device = gemm3.LAUNCHES, gemm3.DEVICE_LAUNCHES
    l = out_of_core_cholesky(x, pipeline_width=width)
    assert gemm3.LAUNCHES - calls == 6 and gemm3.DEVICE_LAUNCHES - device == 18  # 4 panels
    assert l.storage == "host" and l.get_block(5, 2).is_pinned()
    x_cpu = shard_matrix(a.cpu(), tile=(128, 128), storage="host", symmetric=True, device="cpu")
    l_cpu = out_of_core_cholesky(x_cpu, pipeline_width=width)
    assert l.spill_stats == l_cpu.spill_stats
    got = l.to_hbm().array
    _close(got, l_cpu.to_hbm().array.to("cuda"))
    _close(torch.tril(got) @ torch.tril(got).T, a)


def test_svd_jacobi_on_the_card(gen):
    """svd_jacobi on a CUDA tensor: the factors stay on the card and agree
    with the CPU run of the same input (sigma within 1e-5·s_max); both hold
    tests/test_jacobi.py's reconstruction (1e-4) and orthogonality (1e-5)."""
    from numpywren_tpu_torch import models

    x = _rand(gen, 256, 256)
    u, s, vt = models.svd_jacobi(x, block=64)
    assert u.device.type == "cuda" and s.device.type == "cuda"
    _, s_cpu, _ = models.svd_jacobi(x.cpu(), block=64)
    assert float((s.cpu() - s_cpu).abs().max()) <= 1e-5 * float(s_cpu[0])
    u, s, vt, x64 = u.double(), s.double(), vt.double(), x.double()
    eye = torch.eye(256, dtype=torch.float64, device="cuda")
    assert float(torch.linalg.norm((u * s) @ vt - x64) / torch.linalg.norm(x64)) < 1e-4
    assert float(torch.linalg.norm(u.T @ u - eye)) / 16 < 1e-5
    assert float(torch.linalg.norm(vt @ vt.T - eye)) / 16 < 1e-5


@pytest.mark.parametrize("route", ["library", "compensated", "NPW_PALLAS_FACTOR",
                                   "NPW_PALLAS_CHAIN", "normal"])
def test_least_squares_on_the_card(gen, monkeypatch, route):
    """least_squares on CUDA tensors against the CPU run of the same input
    (x within 1e-5 relative): the compensated applies launch matmul3, the
    opt-ins potrf_inv and the chain kernel."""
    import numpy as np

    from numpywren_tpu_torch import config, models
    from numpywren_tpu_torch.ops import pallas_factor as pf

    if route == "compensated":
        monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=True))
    elif route.startswith("NPW_"):
        monkeypatch.setenv(route, "1")
    a = _rand(gen, 8192, 128)
    b = a @ _rand(gen, 128, 2) + 0.1 * _rand(gen, 8192, 2)
    method = "normal" if route == "normal" else "qr"
    pf.reset_launches()
    calls = gemm3.LAUNCHES
    x = models.least_squares(a, b, method=method)
    launched = {"compensated": gemm3.LAUNCHES - calls,
                "NPW_PALLAS_FACTOR": pf.LAUNCHES["potrf_inv"],
                "NPW_PALLAS_CHAIN": pf.LAUNCHES["cholqr2_chain"]}
    if route in launched:
        assert launched[route] > 0
    x_cpu = models.least_squares(a.cpu(), b.cpu(), method=method)
    assert np.linalg.norm(x - x_cpu) <= 1e-5 * np.linalg.norm(x_cpu)


@pytest.mark.parametrize("route,tile", [("high", 128), ("compensated", 128), ("highest", 128),
                                        ("house", 128), ("NPW_PALLAS_CHAIN", 256),
                                        ("NPW_PALLAS_FACTOR", 128)])
def test_fused_bdfac_on_the_card(gen, monkeypatch, route, tile):
    """fused_bdfac on a CUDA tensor (768², three or six panels) against the
    CPU run of the same input (B within 1e-4 relative; both sides sigma
    within 1e-4·s_max of fp64): the compensated sweeps launch matmul3,
    "highest" matmul, the opt-ins the chain (both forms) and potrf_inv."""
    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.compiler.lower import fused_bdfac
    from numpywren_tpu_torch.ops import pallas_factor as pf

    kw = {}
    if route == "compensated":
        monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=True))
    elif route in ("highest", "high"):
        kw["precision"] = route
    elif route == "house":
        kw["panel_method"] = "house"
    else:
        monkeypatch.setenv(route, "1")
    x = _rand(gen, 768, 768)
    pf.reset_launches()
    calls, mm = gemm3.LAUNCHES, gemm.LAUNCHES
    b = fused_bdfac(x, tile, **kw)
    launched = {"compensated": gemm3.LAUNCHES - calls, "highest": gemm.LAUNCHES - mm,
                "NPW_PALLAS_CHAIN": pf.LAUNCHES["cholqr2_chain"],
                "NPW_PALLAS_FACTOR": pf.LAUNCHES["potrf_inv"]}
    if route in launched:
        assert launched[route] > 0
    b_cpu = fused_bdfac(x.cpu(), tile, **kw)
    _close(b.cpu(), b_cpu, bar=1e-4)
    s_ref = torch.linalg.svdvals(x.double())
    for bb in (b, b_cpu.to("cuda")):
        assert float((torch.linalg.svdvals(bb.double()) - s_ref).abs().max()) <= 1e-4 * float(
            s_ref[0])


def test_band_reduce_on_the_card(gen):
    """The chase on the card against the CPU chase of the same band
    (magnitudes within 1e-4·max|A|: a complete QR's signs may differ where
    a block is at roundoff level), sigma within 2e-5·s_max of fp64."""
    import numpy as np

    from numpywren_tpu_torch.models import band_reduce

    a = torch.triu(_rand(gen, 512, 512))
    a = a - torch.triu(a, 129)
    red, ku2 = band_reduce.band_reduce(a, ku=128, w=32)
    red_cpu, _ = band_reduce.band_reduce(a.cpu(), ku=128, w=32)
    assert ku2 == 63
    assert np.abs(np.abs(red) - np.abs(red_cpu)).max() <= 1e-4 * np.abs(red_cpu).max()
    s_ref = np.linalg.svd(a.cpu().double().numpy(), compute_uv=False)
    s = np.sort(np.linalg.svd(red.astype(np.float64), compute_uv=False))[::-1][:512]
    assert np.abs(s - s_ref).max() <= 2e-5 * s_ref[0]


def test_singular_values_and_svd_on_the_card(gen):
    """singular_values (band 512 > 256: band_reduce on the card, then the
    host finish) and svd(method=None -> "bdfac") on a CUDA tensor: sigma
    within 1e-4·s_max of fp64, the CPU run's sigma within 1e-5·s_max; svd
    reconstructs within 1e-4 with UᵀU, VVᵀ within 5e-4 of I."""
    import numpy as np

    from numpywren_tpu_torch import models

    x = _rand(gen, 1024, 1024)
    s_ref = np.linalg.svd(x.cpu().double().numpy(), compute_uv=False)
    s = models.singular_values(x)
    assert np.abs(s - s_ref).max() <= 1e-4 * s_ref[0]
    assert np.abs(s - models.singular_values(x.cpu())).max() <= 1e-5 * s_ref[0]
    x = x[:256, :256].contiguous()
    u, s, vt = models.svd(x, tile=64)
    x64 = x.cpu().double().numpy()
    rec = (u.astype(np.float64) * s) @ vt.astype(np.float64)
    assert np.linalg.norm(rec - x64) / np.linalg.norm(x64) < 1e-4
    assert np.abs(u.T @ u - np.eye(256)).max() < 5e-4
    assert np.abs(vt @ vt.T - np.eye(256)).max() < 5e-4


def test_qdwh_on_the_card(gen):
    """qdwh and the SVD on it on a CUDA tensor (768 x 512, the QR steps and
    the Cholesky steps): one matmul kernel call a step, two for the
    Newton-Schulz step and one for h, u and h
    within 1e-5 of the CPU run of the same input, the same iterations;
    svd(method="qdwh") at 512² holds tests/test_models.py's bars
    (reconstruction, max |UᵀU − I|, |VVᵀ − I| below 1e-5, σ within
    1e-5·σ_max of the CPU run)."""
    import numpy as np

    from numpywren_tpu_torch import models
    from numpywren_tpu_torch.models import qdwh

    x = _rand(gen, 768, 512)
    calls = gemm.LAUNCHES
    u, h, iters, conv = qdwh.qdwh(x)
    assert gemm.LAUNCHES - calls == iters + 3 and u.device.type == "cuda"  # + Newton-Schulz, h
    u_cpu, h_cpu, iters_cpu, conv_cpu = qdwh.qdwh(x.cpu())
    assert (iters, conv) == (iters_cpu, conv_cpu) and conv
    _close(u.cpu(), u_cpu)
    _close(h.cpu(), h_cpu)
    x = x[:512].contiguous()
    u, s, vt = models.svd(x, method="qdwh")
    x64 = x.cpu().double().numpy()
    rec = (u.astype(np.float64) * s) @ vt.astype(np.float64)
    assert np.linalg.norm(rec - x64) / np.linalg.norm(x64) < 1e-5
    assert np.abs(u.T.astype(np.float64) @ u - np.eye(512)).max() < 1e-5
    assert np.abs(vt.astype(np.float64) @ vt.T - np.eye(512)).max() < 1e-5
    s_cpu = models.svd(x.cpu(), method="qdwh")[1]
    assert np.abs(s - s_cpu).max() <= 1e-5 * s_cpu[0]


@pytest.mark.parametrize("route,pt", [("high", 2), ("compensated", 2), ("highest", 2),
                                      ("NPW_PALLAS_CHAIN", 1), ("NPW_PALLAS_FACTOR", 1)])
def test_out_of_core_bdfac_on_the_card(gen, monkeypatch, route, pt):
    """out_of_core_bdfac of a 1024² host tier (tile 128, W = 256 or 128)
    against the CPU run of the same input: B within 1e-4 (relative
    Frobenius), σ(B) within 1e-4·σ_max of fp64, B's tiles pinned; the
    compensated applies launch matmul3, "highest" matmul, the opt-ins the
    chain and potrf_inv. A missing wait between a download and the upload
    that reads it shows here as a B that differs from the CPU's."""
    from numpywren_tpu_torch import config
    from numpywren_tpu_torch.matrix_init import shard_matrix
    from numpywren_tpu_torch.ops import pallas_factor as pf
    from numpywren_tpu_torch.runtime import spill

    kw = {}
    if route == "compensated":
        monkeypatch.setattr(config, "_default", config.NpwConfig(compensated=True))
    elif route == "highest":
        kw["precision"] = route
    elif route.startswith("NPW_"):
        monkeypatch.setenv(route, "1")
    a = _rand(gen, 1024, 1024)
    x = shard_matrix(a, tile=(128, 128), storage="host")
    pf.reset_launches()
    calls, mm = gemm3.LAUNCHES, gemm.LAUNCHES
    b = spill.out_of_core_bdfac(x, panel_tiles=pt, **kw)
    launched = {"compensated": gemm3.LAUNCHES - calls, "highest": gemm.LAUNCHES - mm,
                "NPW_PALLAS_CHAIN": pf.LAUNCHES["cholqr2_chain"],
                "NPW_PALLAS_FACTOR": pf.LAUNCHES["potrf_inv"]}
    if route in launched:
        assert launched[route] > 0
    assert b.get_block(0, 1).is_pinned()
    x_cpu = shard_matrix(a.cpu(), tile=(128, 128), storage="host", device="cpu")
    b_cpu = spill.out_of_core_bdfac(x_cpu, panel_tiles=pt, **kw)
    got = b.to_hbm().array
    _close(got.cpu(), b_cpu.to_hbm().array, bar=1e-4)
    s_ref = torch.linalg.svdvals(a.double())
    assert float((torch.linalg.svdvals(got.double()) - s_ref).abs().max()) <= 1e-4 * float(
        s_ref[0])
