"""``device_type`` and ``histogram_pool_size`` in lightgbm_tpu_torch,
held against the JAX package's ``OverallConfig`` parsing the same
parameters live.

``device_type`` names the device under the port's rule (device.py):
``cpu`` runs the plain versions, ``gpu`` or ``cuda`` the card, anything
else (``tpu`` included) is a Fatal naming the key, and so is a
``device`` that names the other one.  ``histogram_pool_size`` is a float
checked as the JAX package checks it, with no effect on the trees.
"""
import numpy as np
import pytest

from lightgbm_tpu.config import OverallConfig as JConfig
from lightgbm_tpu.utils import log as jlog

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch.utils import log

BASE = {"objective": "binary", "task": "train"}


def _both(params):
    """(JAX config, port config) after parsing ``params``."""
    j, t = JConfig(), lgt.OverallConfig()
    j.set(dict(BASE, **params), require_data=False)
    t.set(dict(BASE, **params), require_data=False)
    return j, t


@pytest.mark.parametrize("value,device", [("cpu", "cpu"), ("gpu", "cuda"),
                                          ("cuda", "cuda"), ("GPU", "cuda"),
                                          ("Cpu", "cpu")])
def test_device_type_parses_as_jax(value, device):
    j, t = _both({"device_type": value})
    assert t.device_type == j.device_type == value
    assert t.device == device


@pytest.mark.parametrize("device,device_type", [("cpu", "cpu"),
                                                ("cuda", "gpu"),
                                                ("cuda:0", "cuda")])
def test_device_and_device_type_agreeing(device, device_type):
    _, t = _both({"device": device, "device_type": device_type})
    assert t.device == device


@pytest.mark.parametrize("value", ["tpu", "TPU", "metal", "xla"])
def test_other_device_type_is_fatal(value):
    JConfig().set(dict(BASE, device_type=value), require_data=False)
    with pytest.raises(log.Fatal, match="device_type"):
        lgt.OverallConfig().set(dict(BASE, device_type=value),
                                require_data=False)


@pytest.mark.parametrize("device,device_type", [("cpu", "gpu"),
                                                ("cuda", "cpu"),
                                                ("cpu", "cuda")])
def test_disagreeing_device_is_fatal(device, device_type):
    with pytest.raises(log.Fatal, match="device=%s and device_type=%s"
                       % (device, device_type)):
        lgt.OverallConfig().set(dict(BASE, device=device,
                                     device_type=device_type),
                                require_data=False)


@pytest.mark.parametrize("value", ["-1", "0", "1024", "2.5", "-0.5"])
def test_histogram_pool_size_parses_as_jax(value):
    j, t = _both({"histogram_pool_size": value})
    got = t.boosting_config.tree_config.histogram_pool_size
    assert got == j.boosting_config.tree_config.histogram_pool_size
    assert got == float(value)


def test_histogram_pool_size_junk_is_jax_fatal():
    params = dict(BASE, histogram_pool_size="lots")
    with pytest.raises(jlog.LightGBMError) as want:
        JConfig().set(params, require_data=False)
    with pytest.raises(log.Fatal) as got:
        lgt.OverallConfig().set(params, require_data=False)
    assert str(got.value) == str(want.value)
    assert "histogram_pool_size" in str(got.value)


def _data():
    rng = np.random.RandomState(3)
    x = rng.randn(600, 5)
    y = (x[:, 0] + 0.3 * rng.randn(600) > 0).astype(np.float32)
    return lgt.Dataset.from_arrays(x, y, max_bin=31)


PARAMS = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 5,
          "num_iterations": 3, "verbose": -1}


def test_device_type_cpu_trains_as_device_cpu():
    """device_type=cpu alone puts training on the CPU, and neither key
    changes the trees: the model text of device=cpu."""
    ds = _data()
    want = lgt.train(dict(PARAMS, device="cpu"), ds).model_to_string()
    got = lgt.train(dict(PARAMS, device_type="cpu"), ds)
    assert got.device.type == "cpu"
    assert got.model_to_string() == want
    pooled = lgt.train(dict(PARAMS, device_type="cpu",
                            histogram_pool_size="64"), ds)
    assert pooled.model_to_string() == want


def test_device_type_gpu_needs_the_card(monkeypatch):
    """device_type=gpu asks for the card: without one it is the default
    device's Fatal, never a quiet run on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(log.Fatal, match="no CUDA device"):
        lgt.train(dict(PARAMS, device_type="gpu"), _data())
