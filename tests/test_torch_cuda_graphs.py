"""The serving body's CUDA graphs (utils/cuda_graphs.py) and the host syncs
they need gone.

On the CPU, with torch.cuda's graph calls faked: a stage's outputs pass to
the next stage's graph in place, a signature of other shapes or constants
captures anew, a capture that fails raises with the capture ended, the
stage list decides what replays, and a capture cut at modules replays each
module's part inside a call of that module.  The weight layouts take their
Cin permutations from the device after the first call; the pixel clamps of
sample prep and full attention's scale keep their bits without a copy from
the host; a singular P still raises on the CPU.  On the card (``gpu``):
the graphed body's outputs are bit-equal to the eager body's at B = 8 and
1 under the serving configuration, under the two variant serving
configurations, and at B = 8 under the `.t7` one (banded k-NN and gather),
each KPConv's hooks fire as often as eagerly, and a replayed request runs
with synchronising CUDA calls made errors.  Imports no JAX: ``python -m
pytest --noconftest tests/test_torch_cuda_graphs.py`` runs the card tests
too."""

import contextlib
import types

import pytest
import torch

from cofii2p_tpu_torch.ops import attention_kernel, kpconv_kernel
from cofii2p_tpu_torch.utils import cuda_graphs, profiling


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture
def fake_graphs(monkeypatch):
    """torch.cuda's graph calls for the CPU: a capture runs its function
    (so the static outputs are the capture's), a replay only counts.
    ``state.open`` counts the captures begun and not ended;
    ``state.nodes`` gives each captured part's node count in turn (3 once
    it runs out)."""
    state = types.SimpleNamespace(replays=[], nodes=[], open=0)

    class Fake:
        def __init__(self, *a, **kw):
            pass

        def wait_stream(self, other):
            pass

        def capture_begin(self, pool=None, capture_error_mode="global"):
            state.open += 1

        def capture_end(self):
            state.open -= 1
            self.nodes = state.nodes.pop(0) if state.nodes else 3

        def instantiate(self):
            pass

        def replay(self):
            state.replays.append(self)

    for name in ("Stream", "CUDAGraph", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, Fake)
    monkeypatch.setattr(torch.cuda, "stream", lambda *a, **kw: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(cuda_graphs, "graph_nodes", lambda g: g.nodes)
    return state


def test_stage_outputs_pass_to_the_next_stage_in_place(fake_graphs):
    graphs = cuda_graphs.GraphSet()
    calls = []

    def first(batch, scale):
        calls.append("first")
        return {"pts": [batch["x"] * scale, batch["x"] + 1], "y": batch["y"]}

    def second(out):
        calls.append("second")
        return out["pts"][0] + out["pts"][1] + out["y"]

    a, b = graphs.stage("prep", first), graphs.stage("fine_match", second)
    assert graphs.stage("prep", second) is a  # one graph a stage name
    x, y = torch.arange(4.0), torch.ones(4)
    out = a({"x": x, "y": y}, 2.0)
    z = b(out)
    assert torch.equal(z, x * 2 + x + 1 + 1) and calls == ["first"] * 2 + ["second"] * 2  # warm-up, capture
    (_, a_in, a_out), = a.graphs.values()
    (_, b_in, b_out), = b.graphs.values()
    assert a_in[0] is not x and a_in[1] is not y  # the caller's tensors are copied in
    assert b_in[0] is a_out["pts"][0] and b_in[2] is a_out["y"] is a_in[1]  # read in place
    assert all(t._graph_static for t in a_in + b_in + [b_out])
    assert a({"x": x + 5, "y": y}, 2.0) is a_out and torch.equal(a_in[0], x + 5)  # copied into the buffer
    assert b(a_out) is b_out and len(fake_graphs.replays) == 4 and len(calls) == 4
    a({"x": x, "y": y}, 3.0)  # another constant: another signature
    a({"x": torch.zeros(6), "y": torch.ones(6)}, 2.0)  # other shapes
    assert len(a.graphs) == 3 and len(calls) == 8
    table = profiling.span_table()
    assert table["cofii2p.graph.prep.captures"] == {"value": 3}
    assert table["cofii2p.graph.prep.graph_nodes"] == {"value": 9}
    assert table["cofii2p.graph.fine_match.captures"] == {"value": 1}


def test_a_failed_capture_leaves_the_signature_eager(fake_graphs):
    """A capture that fails raises, naming its stage, with the capture
    ended; no graph is kept for the signature, so it is never replayed
    half captured, and the next call captures anew."""
    sync = [True]
    calls = []

    def fn(x):
        calls.append(x)
        if fake_graphs.open and sync[0]:
            raise RuntimeError("operation not permitted when stream is capturing")  # as a host sync raises
        return x * 2

    graphed = cuda_graphs.CudaGraphed(fn, "cofii2p.graph.prep")
    with pytest.raises(RuntimeError, match="cofii2p.graph.prep: CUDA graph capture failed"):
        graphed(torch.ones(3))
    assert len(calls) == 2 and graphed.graphs == {} and fake_graphs.open == 0  # warm-up, capture
    sync[0] = False
    assert torch.equal(graphed(torch.ones(3) * 4), torch.full((3,), 8.0)) and len(calls) == 4
    assert profiling.span_table()["cofii2p.graph.prep.captures"] == {"value": 1}


def test_stages_replay_only_in_a_serving_body_on_the_card_with_grad_off():
    """The stage list decides: a set replays the stages it names, binds a
    method to its stage only inside the block, and runs the others (all
    of them for the eager set make_eval_body takes for CPU tensors)."""
    from cofii2p_tpu_torch.config import KITTIConfig

    assert cuda_graphs.serving_stages(KITTIConfig()) == cuda_graphs.STAGES
    assert cuda_graphs.serving_stages(KITTIConfig(kpconv_impl="gather")) == (
        "pc_encoder", "network", "fine_match", "ransac")  # the gather k-NN maps wait for the card
    with pytest.raises(ValueError, match="no serving stage"):
        cuda_graphs.GraphSet(("prep", "heads"))
    fn = lambda x: x  # noqa: E731
    assert cuda_graphs.GraphSet(()).stage("prep", fn) is fn
    graphs = cuda_graphs.GraphSet(("network", "ransac"))
    assert graphs.stage("prep", fn) is fn
    stage = graphs.stage("ransac", fn)
    assert isinstance(stage, cuda_graphs.CudaGraphed) and stage.prefix == "cofii2p.ransac"
    model = torch.nn.Linear(2, 2)
    with graphs.bound(model, "forward", "network"):
        assert model.forward is graphs.stages["network"] and model.forward.prefix == "cofii2p.graph.network"
    assert "forward" not in vars(model) and model.forward.__func__ is torch.nn.Linear.forward
    with graphs.bound(model, "forward", "pc_encoder"):  # not a stage of this set
        assert "forward" not in vars(model)


def test_a_capture_cut_at_modules_replays_their_parts_inside_their_calls(fake_graphs):
    """The point branch's capture is cut at each KPConv's forward: each
    such part replays inside a call of its module, so the module's hooks
    bracket its graph as they bracket its kernels eagerly; a part between
    two cut modules that holds no work is dropped."""
    inner = [torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)]
    net = torch.nn.Sequential(inner[0], inner[1], torch.nn.ReLU())
    seen = []
    for i, m in enumerate(inner):
        m.register_forward_pre_hook(lambda mod, args, i=i: seen.append(("in", i, len(fake_graphs.replays))))
        m.register_forward_hook(lambda mod, args, out, i=i: seen.append(("out", i, len(fake_graphs.replays))))
    fake_graphs.nodes = [0, 5, 0, 7, 2]  # none before the first Linear, none between the two
    graphed = cuda_graphs.CudaGraphed(net, "cofii2p.graph.pc_encoder", split_at=inner)
    x = torch.randn(3, 4)
    with torch.no_grad():
        want = net(x)
        got = graphed(x)
    assert torch.equal(got, want)
    (parts, _, _), = graphed.graphs.values()
    assert [m for m, _ in parts] == [inner[0], inner[1], None] and [g.nodes for _, g in parts] == [5, 7, 2]
    assert profiling.span_table()["cofii2p.graph.pc_encoder.graph_nodes"] == {"value": 14}
    seen.clear()
    fake_graphs.replays.clear()
    graphed(x)
    assert fake_graphs.replays == [g for _, g in parts]
    assert seen == [("in", 0, 0), ("out", 0, 1), ("in", 1, 1), ("out", 1, 2)]  # each part inside its call
    assert all("forward" not in vars(m) for m in inner)


@pytest.mark.parametrize("layout", ["mma", "tf32"])
def test_layout_permutations_come_from_the_device_after_the_first_call(layout, monkeypatch):
    make = kpconv_kernel.mma_weights if layout == "mma" else kpconv_kernel.tf32_weights
    perm = (kpconv_kernel._mma_perm if layout == "mma" else kpconv_kernel._tf32_perm)(64)
    w = torch.randn(15, 40, 24, generator=torch.Generator().manual_seed(0))
    first = make(w, 64, 32)
    padded = torch.zeros(15, 64, 32, dtype=first.dtype)
    padded[:, :40, :24] = w.to(first.dtype)
    assert torch.equal(first, padded[:, perm].transpose(1, 2))
    assert kpconv_kernel._perm_on(layout, 64, w.device) is kpconv_kernel._perm_on(layout, 64, w.device)

    def no_host_copy(*a, **kw):
        raise AssertionError("a layout copied its permutation from the host again")

    monkeypatch.setattr(torch, "as_tensor", no_host_copy)
    assert torch.equal(make(w, 64, 32), first)
    assert torch.equal(kpconv_kernel.fused_weights(w, first.dtype), make(w, 64, 32))


def _bounds_clamp(xy, x_max, y_max):
    """The clamp prepare_samples made before, to a bounds tensor."""
    hi = torch.tensor([x_max, y_max], dtype=torch.float32, device=xy.device)
    return torch.minimum(torch.clamp(xy, min=0.0), hi)


def test_pixel_clamp_keeps_the_bits_of_a_bounds_tensor():
    from cofii2p_tpu_torch.data.device_pipeline import _clamp_xy

    v = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 0.0, -3.5, 7.25, 63.0, 63.5, 1e30, -1e30])
    xy = torch.stack(torch.meshgrid(v, v, indexing="ij"), -1).reshape(-1, 2)
    assert torch.equal(_clamp_xy(xy, 63, 19).view(torch.int32), _bounds_clamp(xy, 63, 19).view(torch.int32))


def test_prepare_samples_keeps_its_bits(monkeypatch):
    """prepare_samples with the supervision fields, against the same call
    with the bounds-tensor clamps and linalg.inv it had."""
    from cofii2p_tpu_torch.config import TinyConfig
    from cofii2p_tpu_torch.data import device_pipeline
    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset
    from cofii2p_tpu_torch.ops.pyramid import random_level_perms

    cfg = TinyConfig()
    ds = SyntheticDataset(cfg, "train", length=2)
    hb = _collate([ds[0], ds[1]])
    hb = {k: torch.as_tensor(v) for k, v in hb.items() if k != "index"}
    gen = torch.Generator().manual_seed(3)
    perms = random_level_perms(2, cfg.pyramid_sizes, gen, "cpu")
    s, h8, w8 = cfg.num_superpoints, cfg.pe_H, cfg.pe_W
    noise = {k: -torch.log(-torch.log(torch.rand(2, n, generator=gen).clamp(min=1e-30)))
             for k, n in (("kpt", s), ("outline", s), ("img_outline", h8 * w8))}

    def prep():
        return device_pipeline.prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, perms,
                                               keypoint_noise=noise)

    got = prep()
    monkeypatch.setattr(device_pipeline, "_clamp_xy", _bounds_clamp)
    monkeypatch.setattr(torch.linalg, "inv_ex", lambda a: (torch.linalg.inv(a), torch.zeros(a.shape[0], dtype=torch.int32)))
    want = prep()
    assert got.keys() == want.keys()
    for k in got:
        for a, b in zip(*(x if isinstance(x, list) else [x] for x in (got[k], want[k]))):
            same = a.view(torch.int32) if a.dtype == torch.float32 else a
            assert torch.equal(same, b.view(torch.int32) if b.dtype == torch.float32 else b), k


def test_prepare_samples_refuses_a_singular_P_on_the_cpu():
    from cofii2p_tpu_torch.config import TinyConfig
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.ops.pyramid import random_level_perms

    cfg = TinyConfig()
    gen = torch.Generator().manual_seed(0)
    pc = torch.randn(2, cfg.num_pc, 3, generator=gen)
    P = torch.eye(4).repeat(2, 1, 1)
    P[1, 2] = 0.0  # a row of zeros
    perms = random_level_perms(2, cfg.pyramid_sizes, gen, "cpu")
    img = torch.zeros(2, cfg.img_H, cfg.img_W, 3)
    with pytest.raises(torch.linalg.LinAlgError, match=r"P of frames \[1\] is singular"):
        prepare_samples(pc, torch.randn(2, cfg.num_pc, 4, generator=gen), P, torch.eye(3).repeat(2, 1, 1), img, cfg,
                        perms)


def test_full_attention_scale_is_kept_on_the_device():
    q, k, v = (torch.randn(2, 5, 4, 32, generator=torch.Generator().manual_seed(i)) for i in range(3))
    scale = attention_kernel._sqrt_on(32, q.device)
    assert scale is attention_kernel._sqrt_on(32, q.device)
    logits = torch.einsum("blhd,bshd->bhls", q, k) / torch.sqrt(torch.tensor(32, dtype=torch.float32))
    want = torch.einsum("bhls,bshd->blhd", torch.softmax(logits, dim=-1), v)
    assert torch.equal(attention_kernel.full_attention(q, k, v), want)


# --- on the card -------------------------------------------------------------


def _same_bits(a, b) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32 if a.element_size() == 4 else torch.int16), b.view(
            torch.int32 if b.element_size() == 4 else torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


# the variant serving configurations that chip_smoke.py's VARIANTS runs
VARIANT_OVERRIDES = {
    "variant_linear": dict(attention="linear", norm="ln", kpconv_dynamic_center="centroid", kernel_size=20),
    "variant_span": dict(kpconv_dynamic_center="span", kernel_size=12),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["kitti-8", "kitti-1", "kitti_t7-8", "kitti_t7_gather-8", "variant_linear-8",
                                  "variant_span-8"])
def test_graphed_body_is_bit_equal_to_the_eager_body_and_replays_without_syncs(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured only on the card")
    from cofii2p_tpu_torch.config import KITTIConfig, apply_overrides
    from cofii2p_tpu_torch.data.loader import _collate
    from cofii2p_tpu_torch.data.synthetic import SyntheticDataset
    from cofii2p_tpu_torch.evaluation import pipeline
    from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
    from cofii2p_tpu_torch.models.kpconv import KPConv
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.utils.convert import randomize
    from cofii2p_tpu_torch.utils.kernel_bench import serve_config, t7_model

    name, b = case.split("-")
    b = int(b)
    dev = torch.device("cuda")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)  # as the CLIs run fp32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    if name.startswith("kitti_t7"):
        over = ["kpconv_impl=gather"] if name.endswith("gather") else []
        cfg = reference_ckpt_config(apply_overrides(KITTIConfig(), over), over, dev)
        model = t7_model(cfg, 0, dev)
    else:
        cfg = serve_config().replace(**VARIANT_OVERRIDES.get(name, {}))
        model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(0)).to(dev).eval()
    ds = SyntheticDataset(cfg, "val", length=3 * b)

    def request(i):
        hb = _collate([ds[i * b + j] for j in range(b)])
        hb = {k: torch.as_tensor(v).to(dev) for k, v in hb.items() if k != "index"}
        return hb, pipeline.make_draws(cfg, b, torch.Generator(dev).manual_seed(i), dev)

    kpconv_calls = [0]
    for m in model.pc_encoder.modules():
        if isinstance(m, KPConv):
            m.register_forward_hook(lambda *_: kpconv_calls.__setitem__(0, kpconv_calls[0] + 1))
    requests = [request(i) for i in range(3)]
    want = [pipeline.make_eval_body(cfg, model, stages=())(hb, draws=draws) for hb, draws in requests[:2]]
    eager_calls = kpconv_calls[0] // 2
    graphed = pipeline.make_eval_body(cfg, model)
    got = [graphed(hb, draws=draws) for hb, draws in requests[:2]]  # captures, then replays
    for i in range(2):
        for field in want[i]._fields:
            assert _same_bits(getattr(got[i], field), getattr(want[i], field)), (i, field)
    stages = cuda_graphs.serving_stages(cfg)
    assert ("prep" in stages) == (name != "kitti_t7_gather")
    table = profiling.span_table()
    for stage in stages:
        assert table[cuda_graphs.stage_prefix(stage) + ".captures"]["value"] == 1, stage
    hb, draws = requests[2]
    torch.cuda.synchronize()
    kpconv_calls[0] = 0
    if "prep" in stages:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = graphed(hb, draws=draws)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.R.shape == (b, 3, 3)
    assert kpconv_calls[0] == eager_calls > 0  # each KPConv's part replays inside its call
    assert all("forward" not in vars(m) for m in model.modules()) and "heads" not in vars(model)
