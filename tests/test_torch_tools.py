"""The port's measurement and plotting tools: the parameter count against
the JAX package's, get_flops_fps on the CPU (every line, and its FLOP and
activation counts against analytic ones), vis_ir and vis_pose (a PNG each,
``project`` against JAX's), the drift tool (drift() on known outputs and
on two tiny forwards, the CLI with --tiny), and utils/profiling.py."""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofii2p_tpu_torch.evaluation import get_flops_fps
from tests.torch_parity import cfg_pair, host_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["TinyConfig", "KITTIConfig"])
def test_param_count_equals_jax(name):
    """JAX counts each KPConv's kernel points, a flax parameter there; the
    port keeps them as buffers and counts them the same."""
    from cofii2p_tpu.data.device_pipeline import prepare_samples
    from cofii2p_tpu.models import CoFiI2P as JCoFiI2P
    from cofii2p_tpu_torch.models.network import CoFiI2P

    jcfg, tcfg = cfg_pair(name)
    hb = host_batch(jcfg, 1)
    batch = jax.eval_shape(lambda: prepare_samples(*(jnp.asarray(hb[k]) for k in ("pc", "attrs", "P", "K")),
                                                   jax.random.PRNGKey(0), jnp.asarray(hb["img"]), jcfg))
    shapes = jax.eval_shape(lambda b: JCoFiI2P(jcfg).init(jax.random.PRNGKey(0), b, mode="train", train=True),
                            batch)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes["params"]))
    assert get_flops_fps.param_count(CoFiI2P(tcfg)) == n_jax


def test_get_flops_fps_prints_every_line(capsys, monkeypatch):
    """Every line the CLI prints (its times from one call each here)."""
    from cofii2p_tpu_torch.utils.profiling import timeit_sync

    monkeypatch.setattr(get_flops_fps, "timed", lambda fn, *a, **kw: timeit_sync(fn, *a, warmup=0, iters=1, **kw))
    get_flops_fps.main(["", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    for head in ("params:", "end-to-end pipeline:", "end-to-end pipeline, spans recorded:", "  span cofii2p.eval:",
                 "  span cofii2p.transformer:", "network forward:", "network flops/frame:",
                 "network activations/frame:", "network peak memory:", "pnp-ransac alone:"):
        assert any(line.startswith(head) for line in out.splitlines()), (head, out)
    flops = float(next(line for line in out.splitlines() if "flops/frame" in line).split()[2])
    assert flops > 0


def test_count_work_of_library_ops_is_analytic():
    """Matmuls and convolutions: FLOPs 2 * multiply-adds, activations the
    elements each launch produces, a module run twice counted twice."""
    lin = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 2))
    conv = torch.nn.Conv2d(3, 5, 3, padding=1, bias=False)
    x, img = torch.randn(3, 4), torch.randn(2, 3, 6, 7)

    def fn():
        lin(x)
        lin(x)
        conv(img)

    flops, acts = get_flops_fps.count_work(fn)
    assert acts == 2 * (3 * 8 + 3 * 2) + 2 * 5 * 6 * 7
    assert flops == 2 * 2 * (3 * 4 * 8 + 3 * 8 * 2) + 2 * (2 * 5 * 6 * 7) * (3 * 3 * 3)


def test_count_work_of_a_kernel_call_is_its_work():
    """A kernel wrapper's call counts the operations kernel_bench.call_work
    reckons for it and its output's elements; what its plain version runs
    on the CPU is not counted."""
    from cofii2p_tpu_torch.ops import kpconv_kernel as kpk
    from cofii2p_tpu_torch.utils.kernel_bench import call_work

    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 256, 3, generator=g) * 8
    f = torch.randn(2, 256, 8, generator=g)
    w = torch.randn(15, 8, 16, generator=g)
    args = (f, pts, pts, w, 0.85, 0.4, 15, 128, 64)
    flops, acts = get_flops_fps.count_work(lambda: kpk.banded_kpconv_fused(*args))
    work = call_work("banded_kpconv_fused", args)
    assert flops == work["ops32"] + work["ops16"] + work["ops_tf32x3"] > 0
    assert acts == 2 * 256 * 16


def test_vis_ir_and_vis_pose_write_png(tmp_path):
    from cofii2p_tpu.evaluation.vis_pose import project as j_project
    from cofii2p_tpu_torch.evaluation import vis_ir, vis_pose

    rng = np.random.default_rng(0)
    ir = tmp_path / "ir.npy"
    np.save(ir, np.linspace(0, 1, 51))
    vis_ir.main([str(ir), "--labels", "port", "--out", str(tmp_path / "ir.png")])
    P = np.eye(4)
    P[:3, 3] = [0.5, -0.2, 1.0]
    K = np.array([[300.0, 0, 128], [0, 300.0, 40], [0, 0, 1]])
    pts = rng.normal(size=(64, 3)) * 3 + [0, 0, 20]
    frame = dict(K=K, object_points=pts, corr_mask=np.arange(64) % 3 > 0, GT_P=P, pred_P=P @ np.diag([1, 1, 1, 1.0]))
    np.save(tmp_path / "frame.npy", frame, allow_pickle=True)
    vis_pose.main([str(tmp_path / "frame.npy"), "--out", str(tmp_path / "pose.png")])
    for png in ("ir.png", "pose.png"):
        assert (tmp_path / png).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    uv, z = vis_pose.project(P, K, pts)
    j_uv, j_z = j_project(P, K, pts)
    np.testing.assert_array_equal(uv, j_uv)
    np.testing.assert_array_equal(z, j_z)


def test_tools_import_no_matplotlib():
    """The card's machine has no matplotlib: the plotting tools import it
    only when they draw."""
    code = ("import sys\n"
            "import cofii2p_tpu_torch.evaluation.vis_ir, cofii2p_tpu_torch.evaluation.vis_pose\n"
            "import cofii2p_tpu_torch.tools.window_drift, cofii2p_tpu_torch.evaluation.get_flops_fps\n"
            "assert 'matplotlib' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, env=env)
    assert res.returncode == 0, res.stderr


def _outs(argmax, mask, fine, score):
    return dict(argmax=torch.tensor(argmax), mask=torch.tensor(mask), fine_xy=torch.tensor(fine, dtype=torch.float32),
                score=torch.tensor(score))


def test_drift_readings_by_hand():
    from cofii2p_tpu_torch.tools.window_drift import drift, selected

    a = _outs([[1, 2, 3, 4]], [[True, False, True, False]], [[[0, 0], [1, 1], [2, 2], [3, 3]]], [[0.1, 0.2, 0.3, 0.4]])
    b = _outs([[1, 0, 3, 0]], [[True, True, False, False]], [[[0, 0], [1, 2], [2, 2], [3, 4]]], [[0.1, 0.25, 0.3, 0.4]])
    d = drift(a, b)
    assert selected(a, b) == 3
    assert d["argmax"] == 0.5 and d["selection"] == 0.5
    assert d["fine_cell"] == pytest.approx(1 / 3)  # row 1 moved and is selected; row 3 moved, unselected
    assert d["score"] == pytest.approx(0.05)
    assert drift(a, a) == dict(argmax=0.0, selection=0.0, fine_cell=0.0, score=0.0)


def test_drift_of_two_tiny_forwards():
    """The same forward twice reads no drift; the same weights, frames and
    draws under w8 windows read some."""
    from cofii2p_tpu_torch.config import TinyConfig
    from cofii2p_tpu_torch.data.device_pipeline import prepare_samples
    from cofii2p_tpu_torch.evaluation.pipeline import make_draws
    from cofii2p_tpu_torch.models.network import CoFiI2P
    from cofii2p_tpu_torch.tools.window_drift import CATALOG, drift, outputs
    from cofii2p_tpu_torch.utils.convert import randomize

    cfg = TinyConfig()
    hb = {k: torch.as_tensor(v) for k, v in host_batch(cfg, 1).items()}
    draws = make_draws(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    model = randomize(CoFiI2P(cfg), torch.Generator().manual_seed(0)).eval()
    batch = prepare_samples(hb["pc"], hb["attrs"], hb["P"], hb["K"], hb["img"], cfg, draws["perms"])
    ref = outputs(model, batch, cfg)
    assert drift(ref, outputs(model, batch, cfg)) == dict(argmax=0.0, selection=0.0, fine_cell=0.0, score=0.0)
    plan, plan_self = CATALOG["w8"]
    wcfg = cfg.replace(kpconv_dynamic_plan=plan, kpconv_dynamic_plan_self=plan_self)
    windowed = CoFiI2P(wcfg).eval()
    windowed.load_state_dict(model.state_dict())
    d = drift(ref, outputs(windowed, batch, wcfg))
    assert all(0.0 <= d[k] <= 1.0 for k in ("argmax", "selection", "fine_cell")) and d["score"] > 0


def test_window_drift_cli_tiny(capsys):
    from cofii2p_tpu_torch.tools import window_drift

    results = window_drift.main(["--tiny", "--frames", "4"])
    assert set(results) == {"w8"} and set(results["w8"]) == {"argmax", "selection", "fine_cell", "score"}
    assert "static reference" in capsys.readouterr().out


def test_timeit_sync_on_the_cpu():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        time.sleep(0.01 * scale)
        return torch.ones(1)

    from cofii2p_tpu_torch.utils.profiling import timeit_sync

    dt = timeit_sync(fn, 1, warmup=1, iters=3, scale=2.0)
    assert len(calls) == 4 and 0.02 <= dt < 0.2


def test_trace_writes_a_chrome_trace(tmp_path):
    from cofii2p_tpu_torch.utils import profiling
    from cofii2p_tpu_torch.utils.profiling import trace

    with profiling.recording(), profiling.span("test.before"):  # not the block's: left out of its spans.json
        pass
    with trace(str(tmp_path / "t")) as prof:
        with profiling.span("test.inside"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    spans = json.loads((tmp_path / "t" / "spans.json").read_text())
    assert spans["test.inside"]["n"] == 1 and "test.before" not in spans
    profiling.reset()
