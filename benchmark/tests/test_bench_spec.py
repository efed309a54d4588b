"""The data files are found by name, an unknown name fails, and
BENCHMARK.json names files that exist and metrics that carry readers."""

import os

import pytest

from benchmark.harness import spec


def test_every_workload_has_its_files():
    bench = spec.benchmark()
    names = {c["name"] for c in bench["configs"]}
    for wl in bench["workloads"]:
        assert wl["config"] in names
        conf = spec.config(wl["config"])
        traffic = spec.traffic(wl["traffic"])
        assert traffic["kind"] in conf["paths"]
        assert set(spec.limits(wl["name"])) and all(v > 0 for v in spec.limits(wl["name"]).values())
        assert spec.cell_metrics(bench, wl["name"], "per_layer")
        assert "setup_s" in [m["name"] for m in spec.cell_metrics(bench, wl["name"], "end_to_end")]
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(spec.ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("loader", [spec.config, spec.traffic, spec.limits, spec.reader])
def test_unknown_names_fail(loader):
    with pytest.raises(FileNotFoundError):
        loader("no-such-name")


def test_unknown_workload_and_config_key_fail():
    with pytest.raises(KeyError):
        spec.workload(spec.benchmark(), "no-such-workload")
    from cofii2p_tpu_torch.config import Config

    with pytest.raises(KeyError):
        spec.make_config(Config, {"no_such_field": 1})


def test_config_files_are_the_ports_configurations():
    import dataclasses

    from cofii2p_tpu_torch.config import Config, KITTIConfig
    from cofii2p_tpu_torch.evaluation.eval_all import reference_ckpt_config
    from cofii2p_tpu_torch.utils.kernel_bench import serve_config

    def fields(name, kind):
        return dataclasses.asdict(spec.make_config(Config, spec.path_config(spec.config(name), kind)))

    assert fields("kitti", "serve") == dataclasses.asdict(serve_config())
    assert fields("kitti", "train") == dataclasses.asdict(KITTIConfig())
    assert fields("kitti_t7", "serve") == dataclasses.asdict(reference_ckpt_config(KITTIConfig(), [], "cuda"))
