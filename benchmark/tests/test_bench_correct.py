"""What decides ``correct``, driven through the rest of a run on the CPU
at TinyConfig's sizes (the look for a card skipped): the reference agrees
with the port's plain path, and the control and each fault the cells can
have come out as not correct."""

import time

import pytest

from benchmark import run
from benchmark.harness import check, faults, serve, train
from benchmark.harness.control import CONTROL
from conftest import tiny_cell

SERVE_CELLS = ["kitti-serve-b8", "kitti_t7-serve-b8"]


def _run(workload, fault=None, seed=2**31 + 11):
    bench, wl, conf, traffic, limits = tiny_cell(workload)
    return run.run_cell(bench, wl, conf, traffic, limits, seed, 0.5, False, time.perf_counter(), "cpu",
                        fault=fault, log=lambda m: None)


def test_reference_matches_the_ports_plain_path():
    """The port on the CPU runs its kernels' plain versions in fp32: the
    reference, written apart from it, gives the same answers."""
    out, judged, _ = _run("kitti_t7-serve-b8")
    assert out["correct"], judged
    assert all(v <= 1e-5 for _, v, _, _ in judged), judged


def test_reference_follows_the_ports_training_steps():
    bench, wl, conf, traffic, limits = tiny_cell("kitti-serve-b8")
    traffic = dict(kind="train", batch=2, pool_batches=3, first_steps=3, profile_steps=1)
    res = train.run(conf, traffic, 5, 0.2, False, time.perf_counter(), "cpu", log=lambda m: None)
    assert res["numbers"]["loss"] < 1e-5 and res["numbers"]["grad"] < 1e-5, res["numbers"]


@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_the_control_is_not_correct(workload):
    _, wl, conf, traffic, limits = tiny_cell(workload)
    fmt = CONTROL[conf["paths"]["serve"]["precision"]]
    numbers = serve.control_numbers(conf, traffic, 7, "cpu", fmt)
    assert not all(ok for *_, ok in check.judge(numbers, limits)), numbers


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
@pytest.mark.parametrize("workload", SERVE_CELLS)
def test_a_broken_serving_path_is_not_correct(workload, fault):
    out, judged, _ = _run(workload, fault=faults.SERVE[fault])
    assert not out["correct"], judged


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_broken_training_step_is_not_correct(fault):
    out, judged, _ = _run("kitti-train-b8", fault=faults.TRAIN[fault])
    assert not out["correct"], judged


def test_the_training_control_is_not_correct():
    _, wl, conf, traffic, limits = tiny_cell("kitti-train-b8")
    numbers = train.control_numbers(conf, traffic, 7, "cpu", CONTROL[conf["paths"]["train"]["precision"]])
    assert not all(ok for *_, ok in check.judge(numbers, limits)), numbers


def test_a_sound_training_run_is_correct():
    out, judged, _ = _run("kitti-train-b8")
    assert out["correct"], judged
