"""RANSAC over EPnP hypotheses, batched over frames and hypotheses
(counterpart of cofii2p_tpu/pose/ransac.py under the eval pipeline's vmap).

The hypothesis draw is an injected input: ``gumbel`` (B, H, N) noise
whose per-hypothesis top-``sample_size`` over valid rows picks the
minimal samples (Gumbel top-k = sampling without replacement).  The parity
tests pass JAX's ``jax.random.gumbel`` draws; :func:`gumbel_noise` draws
them from a ``torch.Generator`` on the card.

:func:`ransac_pnp` takes the plain version (:func:`ransac_pnp_plain`) for
a CPU tensor and launches the kernels of csrc/ransac_pnp.cu for a CUDA
tensor; there is no other fallback.  The JAX package has no TPU kernel
here: the kernels exist because the plain version is a chain of ~24k tiny
launches.

The kernels give the plain version's bits.  On correspondences without a
pose behind them (what seeded random weights give) the plain version is
chaotic: a last-bit change of one sum changes some frames' inlier counts.
So the kernels repeat its every operation with its rounding: each short
matrix product in the order cuBLAS sums the plain version's call at that
batch count (:func:`dot_orders` finds it on the card), and the refinement's
sums over all N correspondences through the plain version's own PyTorch
calls (:func:`run_kernels`), whose order over N changes with B (cuBLAS
splits K at B = 1) and no kernel repeats.  Those products run in IEEE fp32
whatever the caller's TF32 setting (:func:`ieee_fp32_products`): a TF32
product rounds its operands, which no fp32 order repeats.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple

import torch

from cofii2p_tpu_torch.ops import cuda_lib
from cofii2p_tpu_torch.ops.kpconv_kernel import check_no_grad
from cofii2p_tpu_torch.pose.epnp import epnp, refine_pose_gauss_newton, reprojection_errors

SAMPLE_SIZE = 6  # the minimal sample the kernels solve


class RansacResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3)
    inlier_mask: torch.Tensor  # (B, N) bool
    num_inliers: torch.Tensor  # (B,) int32
    success: torch.Tensor  # (B,) bool


class Hypotheses(NamedTuple):
    samples: torch.Tensor  # (B, H, k) row indices
    R: torch.Tensor  # (B, H, 3, 3)
    t: torch.Tensor  # (B, H, 3)
    counts: torch.Tensor  # (B, H) inliers of each hypothesis


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _gather_rows(x, idx):
    """x (B, N, D), idx (B, H, k) -> (B, H, k, D)."""
    b, h, k = idx.shape
    flat = torch.gather(x, 1, idx.reshape(b, h * k, 1).expand(-1, -1, x.shape[-1]))
    return flat.reshape(b, h, k, x.shape[-1])


def ransac_hypotheses_plain(gumbel, object_points, image_points, K, mask, inlier_threshold=8.0, sample_size=6):
    """The hypothesis stage of :func:`ransac_pnp_plain`: each hypothesis's
    sample, EPnP pose and inlier count."""
    m = mask.float()
    b, h, n = gumbel.shape
    scores = torch.where(m[:, None, :] > 0, gumbel, -torch.inf)
    # top-k with ties to the lower index, like lax.top_k
    samples = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :sample_size]
    Kh = K[:, None].expand(b, h, 3, 3)
    ones = torch.ones(b, h, sample_size, dtype=torch.float32, device=gumbel.device)
    Rs, ts, _ = epnp(_gather_rows(object_points, samples), _gather_rows(image_points, samples), Kh, ones)
    err = reprojection_errors(Rs, ts, object_points[:, None], image_points[:, None], Kh)
    counts = ((err < inlier_threshold) & (m[:, None, :] > 0)).sum(-1)
    return Hypotheses(samples, Rs, ts, counts)


def ransac_pnp_plain(gumbel, object_points, image_points, K, mask, inlier_threshold=8.0, sample_size=6,
                     refine_iters=2):
    """Plain version of :func:`ransac_pnp`."""
    m = mask.float()
    b = gumbel.shape[0]
    _, Rs, ts, counts = ransac_hypotheses_plain(gumbel, object_points, image_points, K, mask, inlier_threshold,
                                                sample_size)
    best = torch.argmax(counts, dim=-1)
    bi = torch.arange(b, device=gumbel.device)
    R, t = Rs[bi, best], ts[bi, best]

    for _ in range(refine_iters):
        err = reprojection_errors(R, t, object_points, image_points, K)
        inl = ((err < inlier_threshold) & (m > 0)).float()
        w = torch.where(inl.sum(-1, keepdim=True) >= 4, inl, m)
        R, t, _ = epnp(object_points, image_points, K, w)
        R, t = refine_pose_gauss_newton(R, t, object_points, image_points, K, w, iters=5)

    err = reprojection_errors(R, t, object_points, image_points, K)
    inlier_mask = (err < inlier_threshold) & (m > 0)
    num = inlier_mask.sum(-1).to(torch.int32)
    return RansacResult(R, t, inlier_mask, num, num >= 4)


# csrc/ransac_pnp.cuh's product sites (enum Site) and orders (enum Order)
SITES = ("bary", "cam", "ltl", "ltdw", "mm", "ray1", "ray2", "mq", "qn", "dot4", "rmu", "pr6", "camk6", "prn", "camkn",
         "cov6", "mtm6", "mu6", "s6", "jj", "rr")
CHAIN, SEQ, TREE, EVENODD, SPLIT = range(5)  # SPLIT + s: two FMA chains split at s
# csrc/ransac_pnp.cu's pointer array (enum Ptr) and refinement phases (enum Phase)
_BUFS = ("P", "uv", "K", "m", "hypR", "hypt", "counts", "pose", "w", "wn", "wn2", "wsum", "prodc0", "c0", "cen", "cov",
         "frame", "M", "MtM", "cam1", "cam2", "z1", "z2", "s1", "s2", "mus", "mc1", "mc2", "srcc", "dc1", "dc2", "Sc1",
         "Sc2", "cand", "ew1", "ew2", "e1", "e2", "Jw", "J", "JwP", "r", "Hs", "g", "R", "t", "inliers", "num",
         "success")
BEST, WEIGHTS, CENTRE, FRAME, EIG, MOMENTS, RIGID, PICK, GAUSS_NEWTON, FINAL = range(10)
GN_STEPS = 5  # refine_pose_gauss_newton(..., iters=5)


def _order_candidates(k):
    """The orders a dot product of length k can take, the likeliest first."""
    half = (k + 1) // 2
    out = [CHAIN] + ([SPLIT + half] if 0 < half < k else []) + [EVENODD, SEQ, TREE]
    return out + [SPLIT + s for s in range(1, k) if s != half]


def _dot_np(a, b, order):
    """The kernels' dotk (csrc/ransac_pnp.cuh) in numpy: float32 operations,
    a fused multiply-add rounded once."""
    import numpy as np

    def fma(x, y, acc):
        return (x.astype(np.longdouble) * y + acc).astype(np.float32)

    k = a.shape[1]
    zero = np.zeros(a.shape[0], np.float32)
    if order == CHAIN:
        acc = zero
        for i in range(k):
            acc = fma(a[:, i], b[:, i], acc)
        return acc
    p = (a * b).astype(np.float32)
    if order == SEQ:
        acc = p[:, 0]
        for i in range(1, k):
            acc = (acc + p[:, i]).astype(np.float32)
        return acc
    if order == TREE:  # torch.sum's lanes of width last_pow2(k), then a shuffle-down tree
        w = 1 << (k.bit_length() - 1)
        lanes = [(zero + p[:, j]) + (zero + p[:, j + w]) if j + w < k else zero + p[:, j] for j in range(w)]
        while len(lanes) > 1:
            h = len(lanes) // 2
            lanes = [(lanes[j] + lanes[j + h]).astype(np.float32) for j in range(h)]
        return lanes[0].astype(np.float32)
    x, y = zero, zero
    for i in range(k):
        if (i % 2 == 0) if order == EVENODD else (i < order - SPLIT):
            x = fma(a[:, i], b[:, i], x)
        else:
            y = fma(a[:, i], b[:, i], y)
    return (x + y).astype(np.float32)


def _rows(A, B, out, rows=8):
    """(a, b, out) of a batched product out = A @ B: each output's factor
    rows, from the first ``rows`` rows of A (leading dimensions broadcast)."""
    A, out = A[..., :rows, :], out[..., :rows, :]
    lead = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    A = A.expand(*lead, *A.shape[-2:])
    B = B.expand(*lead, *B.shape[-2:])
    r, k, c = A.shape[-2], A.shape[-1], B.shape[-1]
    a = A[..., :, None, :].expand(*lead, r, c, k)
    b = B.transpose(-1, -2)[..., None, :, :].expand(*lead, r, c, k)
    return a.reshape(-1, k), b.reshape(-1, k), out.reshape(-1)


def _vec(a, b, out):
    """(a, b, out) of a product each of whose outputs is sum_k a[..., k] b[..., k]."""
    k = a.shape[-1]
    return a.reshape(-1, k), b.reshape(-1, k), out.reshape(-1)


def _site_calls(lead, pts, n, K, gen):
    """site -> (a, b, out): the plain version's product calls on random
    operands, at the leading dimensions ``lead`` ((B, H) in the hypothesis
    stage, (B,) in the refinement) with ``pts`` points a problem; ``n`` the
    correspondences a frame, ``K`` the frames' intrinsics."""
    dev = K.device

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    calls = {}
    A = rnd(*lead, pts, 3, scale=10)
    E = rnd(*lead, 3, 3)
    calls["bary"] = _rows(A, E, A @ E)
    al, cc = rnd(*lead, pts, 4), rnd(*lead, 4, 3)
    calls["cam"] = _rows(al, cc, al @ cc)
    L, dw2 = rnd(*lead, 6, 3), rnd(*lead, 6).abs()
    calls["ltl"] = _rows(L.transpose(-1, -2), L, L.transpose(-1, -2) @ L)
    calls["ltdw"] = _rows(L.transpose(-1, -2), dw2[..., None], L.transpose(-1, -2) @ dw2[..., None])
    M, N4, q = rnd(*lead, 4, 4), rnd(*lead, 4, 4), rnd(*lead, 4)
    calls["mm"] = _rows(M, M, M @ M)
    T = torch.einsum("...ij,...ik->...jk", M, N4)
    ray = torch.einsum("...jk,...kj->...j", T, M)
    if not torch.equal(ray, torch.einsum("...ij,...ik,...kj->...j", M, N4, M)):
        raise RuntimeError("einsum('ij,ik,kj->j') is not its two pairwise products at this batch count")
    calls["ray1"] = _rows(M.transpose(-1, -2), N4, T)
    calls["ray2"] = _vec(T, M.transpose(-1, -2), ray)
    calls["mq"] = _vec(M, q[..., None, :].expand_as(M), torch.einsum("...ij,...j->...i", M, q))
    Tq = torch.einsum("...i,...ij->...j", q, N4)
    lam = torch.einsum("...j,...j->...", Tq, q)
    if not torch.equal(lam, torch.einsum("...i,...ij,...j->...", q, N4, q)):
        raise RuntimeError("einsum('i,ij,j->') is not its two pairwise products at this batch count")
    calls["qn"] = _vec(q[..., None, :].expand_as(N4), N4.transpose(-1, -2), Tq)
    calls["dot4"] = _vec(Tq, q, lam)
    R, mu = rnd(*lead, 3, 3), rnd(*lead, 3, scale=10)
    calls["rmu"] = _vec(R, mu[..., None, :].expand_as(R), torch.einsum("...ij,...j->...i", R, mu))
    if len(lead) == 2:  # the hypothesis stage: six points, then all n to count
        b, h = lead
        Kh = K[:, None].expand(b, h, 3, 3)
        P6 = rnd(b, h, 6, 3, scale=10)
        calls["pr6"] = _rows(P6, R.transpose(-1, -2), P6 @ R.transpose(-1, -2))
        calls["camk6"] = _rows(P6, Kh.transpose(-1, -2), P6 @ Kh.transpose(-1, -2))
        Pn = rnd(b, n, 3, scale=10)
        calls["prn"] = _rows(Pn[:, None], R.transpose(-1, -2), Pn[:, None] @ R.transpose(-1, -2))
        camn = rnd(b, h, n, 3, scale=10)
        calls["camkn"] = _rows(camn, Kh.transpose(-1, -2), camn @ Kh.transpose(-1, -2))
        wn, c, d = rnd(b, h, 6).abs(), rnd(b, h, 6, 3, scale=10), rnd(b, h, 6, 3, scale=10)
        calls["cov6"] = _rows((wn[..., None] * c).transpose(-1, -2), c,
                              torch.einsum("...n,...ni,...nj->...ij", wn, c, c))
        M12 = rnd(b, h, 12, 12, scale=100)
        calls["mtm6"] = _rows(M12.transpose(-1, -2), M12, M12.transpose(-1, -2) @ M12)
        calls["mu6"] = _rows(wn[..., None, :], c, torch.einsum("...n,...ni->...i", wn, c)[..., None, :])
        calls["s6"] = _rows((wn[..., None] * c).transpose(-1, -2), d,
                            torch.einsum("...n,...ni,...nj->...ij", wn, c, d))
    else:  # the refinement: all n points of each frame
        Pn = rnd(*lead, n, 3, scale=10)
        calls["prn"] = _rows(Pn, R.transpose(-1, -2), Pn @ R.transpose(-1, -2))
        calls["camkn"] = _rows(Pn, K.transpose(-1, -2), Pn @ K.transpose(-1, -2))
        Jc, Jp = rnd(*lead, n, 2, 3), rnd(*lead, n, 3, 6)
        calls["jj"] = _rows(Jc[:, :64], Jp[:, :64], (Jc @ Jp)[:, :64])
        calls["rr"] = _rows(R, E, R @ E)
    return calls


@contextlib.contextmanager
def ieee_fp32_products():
    """cuBLAS's fp32 products in IEEE fp32 inside the block (TF32 off), the
    caller's setting restored after it, by the API the caller set it with."""
    matmul = torch.backends.cuda.matmul
    try:
        before = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set the per-backend API (matmul.fp32_precision)
        before = matmul.fp32_precision
        if before == "ieee":
            yield
            return
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = before
        return
    if before == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


_orders_cache = {}
_CALIBRATION_OUTPUTS = 2048  # outputs a site needs
_CALIBRATION_REPEATS = 64


def _orders_key(b, h, n, device):
    """What the orders depend on besides the kernels' sources (the file's
    name, :func:`_orders_file`): the sites, the libraries, which BLAS
    library and workspace cuBLAS takes, the card and the sizes.  The
    products are IEEE fp32 (:func:`ieee_fp32_products`)."""
    from importlib import metadata

    try:
        cublas = metadata.version("nvidia-cublas-cu12")
    except metadata.PackageNotFoundError:
        cublas = "bundled"
    return "|".join(map(str, (",".join(SITES), torch.__version__, torch.version.cuda, cublas,
                              torch.backends.cuda.preferred_blas_library(), os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                              torch.cuda.get_device_name(device), b, h, n)))


def _orders_file():
    """The orders beside the kernel library, named after it: a change to the
    kernels' sources (their Site and Order enums) starts a new file."""
    return cuda_lib.library_path()[:-len(".so")] + ".orders.json"


def _valid_orders(entry):
    """A kept entry holds an order for each site at both batch counts."""
    return (isinstance(entry, list) and len(entry) == 2
            and all(isinstance(o, list) and len(o) == len(SITES)
                    and all(isinstance(x, int) and x >= 0 for x in o) for o in entry))


def dot_orders(b, h, n, device):
    """(hypothesis orders, refinement orders): for each product site of the
    kernels (SITES), the order in which cuBLAS sums the plain version's call
    at these sizes, found by running the call on random operands here and
    keeping the first order that gives its bits on every output; raises
    where none does.  Kept beside the kernel library for the same
    libraries, card and sizes, so only a checkout's first process finds
    them (~4 s, the first use of each call).  Call it under
    :func:`ieee_fp32_products`."""
    import json

    key = _orders_key(b, h, n, device)
    if key not in _orders_cache:
        path = _orders_file()
        known = {}
        if os.path.exists(path):
            with open(path) as fh:
                known = json.load(fh)
        if not _valid_orders(known.get(key)):
            known[key] = _find_orders(b, h, n, device)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as fh:
                json.dump(known, fh)
            os.replace(tmp, path)
        _orders_cache[key] = tuple(tuple(o) for o in known[key])
    return _orders_cache[key]


def _find_orders(b, h, n, device):
    import numpy as np

    gen = torch.Generator(device=device).manual_seed(0)
    K = torch.tensor([[300.0, 0, 128], [0, 300.0, 40], [0, 0, 1]], device=device).expand(b, 3, 3).contiguous()
    result = []
    for lead, pts in (((b, h), 6), ((b,), n)):
        # a call at a small batch has few outputs: repeat it on fresh operands
        # (the same call, so the same kernel) until every site has enough to
        # tell the orders apart
        calls = {}
        for _ in range(_CALIBRATION_REPEATS):
            for site, abo in _site_calls(lead, pts, n, K, gen).items():
                calls.setdefault(site, []).append(abo)
            if min(sum(len(o) for _, _, o in v) for v in calls.values()) >= _CALIBRATION_OUTPUTS:
                break
        orders = []
        for site in SITES:
            if site not in calls:
                orders.append(CHAIN)
                continue
            a, bb, out = (torch.cat(parts)[:_CALIBRATION_OUTPUTS].cpu().numpy() for parts in zip(*calls[site]))
            want = out.view(np.int32)
            for order in _order_candidates(a.shape[1]):
                if np.array_equal(_dot_np(a, bb, order).view(np.int32), want):
                    orders.append(order)
                    break
            else:
                raise RuntimeError(
                    f"ransac_pnp: no summation order the kernels know gives cuBLAS's bits for the plain version's "
                    f"{site!r} product at batch {lead} (BLAS library "
                    f"{torch.backends.cuda.preferred_blas_library()}, CUBLAS_WORKSPACE_CONFIG "
                    f"{os.environ.get('CUBLAS_WORKSPACE_CONFIG')}); the kernels match cuBLAS "
                    f"(torch.backends.cuda.preferred_blas_library('cublas')) with its default workspace on the H100, "
                    f"and ransac_pnp_plain runs the plain version on any card")
        result.append(orders)
    return result


def _int_array(values):
    import ctypes

    return (ctypes.c_int * len(values))(*values)


def run_kernels(lib, stream, gumbel, object_points, image_points, K, mask, inlier_threshold, refine_iters, orders):
    """The kernels of csrc/ransac_pnp.cu from ``lib`` (the card's library, or
    a host build of the same arithmetic in the CPU tests) on ``stream``: the
    hypothesis kernel, then the refinement's phases with the plain version's
    own PyTorch calls for its sums over the N points in between."""
    import ctypes

    b, h, n = gumbel.shape
    g, obj, img, Km, m = (x.float().contiguous() for x in (gumbel, object_points, image_points, K, mask))
    thr = float(inlier_threshold)
    hyp_orders, ref_orders = (_int_array(o) for o in orders)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device=g.device)

    hyp = Hypotheses(empty(b, h, SAMPLE_SIZE, dtype=torch.int32), empty(b, h, 3, 3), empty(b, h, 3),
                     empty(b, h, dtype=torch.int32))
    cuda_lib.check(lib.ransac_hyp_launch(
        g.data_ptr(), obj.data_ptr(), img.data_ptr(), Km.data_ptr(), m.data_ptr(), b, h, n, SAMPLE_SIZE, thr,
        hyp_orders, hyp.samples.data_ptr(), hyp.R.data_ptr(), hyp.t.data_ptr(), hyp.counts.data_ptr(), stream),
        "ransac_hyp")
    t = dict(P=obj, uv=img, K=Km, m=m, hypR=hyp.R, hypt=hyp.t, counts=hyp.counts, pose=empty(b, 12), w=empty(b, n),
             wn=empty(b, n), wn2=empty(b, n), wsum=empty(b), prodc0=empty(b, n, 3), cen=empty(b, n, 3),
             frame=empty(b, 27), M=empty(b, 2 * n, 12), srcc=empty(b, n, 3), cand=empty(2, b, 12),
             Jw=empty(b, 6, 2, n), J=empty(b, 2, n, 6), JwP=empty(b, n, 2, 6), r=empty(b, 2, n), R=empty(b, 3, 3),
             t=empty(b, 3),
             inliers=empty(b, n, dtype=torch.bool), num=empty(b, dtype=torch.int32),
             success=empty(b, dtype=torch.bool))
    for c in (1, 2):
        t.update({f"cam{c}": empty(b, n, 3), f"z{c}": empty(b, n), f"dc{c}": empty(b, n, 3), f"ew{c}": empty(b, n)})

    def phase(p, more=0):
        ptrs = (ctypes.c_longlong * len(_BUFS))(*(t[k].data_ptr() if k in t else 0 for k in _BUFS))
        cuda_lib.check(lib.ransac_refine_launch(p, ptrs, ref_orders, b, h, n, thr, more, stream), f"ransac phase {p}")

    # each sum below is the plain version's own call on a tensor of the shape
    # it has there (ransac_pnp_plain, epnp.py, small_linalg.py)
    phase(BEST)
    for _ in range(refine_iters):
        phase(WEIGHTS)
        t["c0"] = torch.sum(t["prodc0"], dim=-2)
        phase(CENTRE)
        t["cov"] = torch.einsum("...n,...ni,...nj->...ij", t["wn"], t["cen"], t["cen"]).contiguous()
        phase(FRAME)
        t["MtM"] = (t["M"].transpose(-1, -2) @ t["M"]).contiguous()
        phase(EIG)
        t["mus"] = torch.einsum("...n,...ni->...i", t["wn2"], object_points).contiguous()
        for c in (1, 2):
            t[f"s{c}"] = t[f"z{c}"].sum(-1)
            t[f"mc{c}"] = torch.einsum("...n,...ni->...i", t["wn2"], t[f"cam{c}"]).contiguous()
        phase(MOMENTS)
        for c in (1, 2):
            t[f"Sc{c}"] = torch.einsum("...n,...ni,...nj->...ij", t["wn2"], t["srcc"], t[f"dc{c}"]).contiguous()
        phase(RIGID)
        for c in (1, 2):
            t[f"e{c}"] = t[f"ew{c}"].sum(-1)
        phase(PICK)
        # the terms as the plain version's (B, N, 2, 6) and (B, N, 2) tensors:
        # views of the layouts einsum takes them to, but for g's Jw
        Jw, J, r = t["Jw"].permute(0, 3, 2, 1), t["J"].permute(0, 2, 1, 3), t["r"].permute(0, 2, 1)
        for step in range(GN_STEPS):
            t["Hs"] = torch.einsum("...nik,...nil->...kl", Jw, J).contiguous()
            t["g"] = torch.einsum("...nik,...ni->...k", t["JwP"], r).contiguous()
            phase(GAUSS_NEWTON, more=int(step < GN_STEPS - 1))
    phase(FINAL)
    return RansacResult(t["R"], t["t"], t["inliers"], t["num"], t["success"]), hyp


def ransac_pnp_kernel(gumbel, object_points, image_points, K, mask, inlier_threshold=8.0, sample_size=6,
                      refine_iters=2):
    """The kernels' result and their hypotheses (samples and counts int32):
    csrc/ransac_pnp.cu's hypothesis kernel, one warp per (frame,
    hypothesis), then its refinement phases, one block per frame, around the
    plain version's sums over the N points."""
    check_no_grad("ransac_pnp (no backward exists)", gumbel, object_points, image_points, K, mask)
    if sample_size != SAMPLE_SIZE:
        raise ValueError(f"sample_size {sample_size} not supported (the kernels solve {SAMPLE_SIZE}-point samples)")
    if gumbel.dim() != 3:
        raise ValueError(f"gumbel must be (B, H, N), got {tuple(gumbel.shape)}")
    b, h, n = gumbel.shape
    want = {"object_points": (b, n, 3), "image_points": (b, n, 2), "K": (b, 3, 3), "mask": (b, n)}
    args = {"gumbel": gumbel, "object_points": object_points, "image_points": image_points, "K": K, "mask": mask}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(args[name].shape)}")
    if n < sample_size or h < 1 or b < 1 or refine_iters < 0:
        raise ValueError(f"need N >= {sample_size}, H >= 1, B >= 1 and refine_iters >= 0; got N {n}, H {h}, B {b}, "
                         f"refine_iters {refine_iters}")
    for name, x in args.items():
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if object_points.dtype != torch.float32:
        raise ValueError("object_points must be float32, as the plain version's sums take them")
    with ieee_fp32_products():
        return run_kernels(cuda_lib.lib(), cuda_lib.stream_of(gumbel), gumbel, object_points, image_points, K, mask,
                           inlier_threshold, refine_iters, dot_orders(b, h, n, gumbel.device))


def ransac_pnp(gumbel, object_points, image_points, K, mask, inlier_threshold=8.0, sample_size=6, refine_iters=2):
    """Robust PnP over fixed-size masked correspondence sets.

    gumbel (B, H, N); object_points (B, N, 3); image_points (B, N, 2);
    K (B, 3, 3); mask (B, N) validity.  success needs >= 4 inliers.

    On the card it computes in IEEE fp32 whatever the TF32 setting, and
    needs cuBLAS to sum the plain version's short products in an order the
    kernels know (:func:`dot_orders`; it raises, naming the setting, where
    none matches).  On the CPU it is :func:`ransac_pnp_plain`.
    """
    if gumbel.device.type == "cpu":
        return ransac_pnp_plain(gumbel, object_points, image_points, K, mask, inlier_threshold, sample_size,
                                refine_iters)
    res, _ = ransac_pnp_kernel(gumbel, object_points, image_points, K, mask, inlier_threshold, sample_size,
                               refine_iters)
    ransac_pnp.launches += 1
    return res


ransac_pnp.launches = 0
