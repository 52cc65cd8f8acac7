"""The port's copies of the JAX package's logging and config helpers
against the originals, on the same inputs.

``maskdit_tpu_torch/utils/logging.py`` and ``utils/config.py`` exist so
that the port imports nothing of the JAX package; they must behave as the
originals do.
"""

import copy
import glob
import json
import os

import pytest

from maskdit_tpu.utils import config as jax_config
from maskdit_tpu.utils import logging as jax_logging
from maskdit_tpu_torch.utils import config, logging

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))


@pytest.mark.parametrize("name,inputs", [
    ("parse_int_list", ["0-63", "1,2,5-10", "7", [3, 4], "0-0,9"]),
    ("parse_float_none", [None, "None", "1.5", "2", 3]),
    ("parse_str_none", [None, "None", "a/b.pt", 7]),
    ("str2bool", [True, False, "True", "true", "1", "yes", "False", "no", "0", 1, 0]),
])
def test_parsers_match(name, inputs):
    ours, theirs = getattr(logging, name), getattr(jax_logging, name)
    for x in inputs:
        assert ours(x) == theirs(x), (name, x)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, ROOT))
def test_load_matches(path):
    ours, theirs = config.load(path), jax_config.load(path)
    assert ours.to_container() == theirs.to_container()
    assert repr(ours) == repr(theirs)
    assert sorted(ours) == sorted(theirs) and len(ours) == len(theirs)


def test_config_node_matches():
    data = {"model": {"model_type": "DiT-XL/2", "in_size": 64, "mask_ratio": 0.5},
            "train": {"lr": 1e-4, "betas": [0.9, 0.999]}, "log": {}}
    nodes = config.ConfigNode(copy.deepcopy(data)), jax_config.ConfigNode(copy.deepcopy(data))
    for node in nodes:
        node.set_path("train.batchsize", 32)
        node.set_path("data.category", "synthetic")
        node.model.in_size = 32
        node["log"]["tag"] = "x"
        del node["model"]["mask_ratio"]
    ours, theirs = nodes
    assert ours.to_container() == theirs.to_container()
    assert ours.select("train.batchsize") == theirs.select("train.batchsize") == 32
    assert ours.select("train.nope", default=None) is theirs.select("train.nope", default=None)
    assert ours.get("eval", 5) == theirs.get("eval", 5) == 5
    assert ("model" in ours) and ("model" in theirs) and "eval" not in ours
    assert copy.deepcopy(ours).to_container() == copy.deepcopy(theirs).to_container()
    # the container is a copy: editing it leaves the node as it was
    container = ours.to_container()
    container["train"]["betas"].append(0)
    assert ours.train.betas == [0.9, 0.999]
    for a, b in ((ours, theirs), (ours.model, theirs.model)):
        with pytest.raises(AttributeError) as e_ours:
            a.missing_key
        with pytest.raises(AttributeError) as e_theirs:
            b.missing_key
        assert str(e_ours.value) == str(e_theirs.value)
    with pytest.raises(KeyError) as e_ours:
        ours.select("model.nope")
    with pytest.raises(KeyError) as e_theirs:
        theirs.select("model.nope")
    assert str(e_ours.value) == str(e_theirs.value)


def test_logger_metrics_and_throughput_match(tmp_path, capsys):
    for name, mod in (("ours", logging), ("theirs", jax_logging)):
        with mod.Logger(str(tmp_path / f"{name}.txt"), "w"):
            print("line one")
            print("line two", flush=True)
        sink = mod.MetricLogger(str(tmp_path / name))
        sink.log({"train/loss": 0.5, "train/lr": 1e-4}, step=3)
        sink.log({"train/loss": 0.25}, step=4)
        sink.close()
        t = mod.Throughput()
        t.update(2, 64)
        rates = t.rates()
        assert set(rates) == {"steps_per_sec", "images_per_sec"}
        assert rates["images_per_sec"] == pytest.approx(32 * rates["steps_per_sec"])
    printed = capsys.readouterr().out
    assert printed == "line one\nline two\n" * 2
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "theirs.txt").read_text()

    def records(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]

    assert records("ours") == records("theirs") == [
        {"step": 3, "train/loss": 0.5, "train/lr": 1e-4}, {"step": 4, "train/loss": 0.25}]
