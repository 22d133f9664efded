"""Backend selection: one function names the platform."""

import types

import pytest

from tpulc.utils import backend


def _fake_devices(monkeypatch, platform):
    dev = types.SimpleNamespace(platform=platform, device_kind="x")
    monkeypatch.setattr(backend.jax, "devices", lambda: [dev])


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_known_platforms(monkeypatch, platform):
    _fake_devices(monkeypatch, platform)
    assert backend.platform() == platform
    assert backend.on_gpu() == (platform == "gpu")


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL"])
def test_unknown_platform_raises(monkeypatch, platform):
    _fake_devices(monkeypatch, platform)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.platform()


def test_failed_backend_init_is_not_hidden(monkeypatch):
    def boom():
        raise RuntimeError("backend failed to initialise")

    monkeypatch.setattr(backend.jax, "devices", boom)
    with pytest.raises(RuntimeError, match="failed to initialise"):
        backend.on_gpu()


def test_this_suite_runs_on_cpu():
    assert backend.platform() == "cpu"


def test_drivers_follow_the_backend(monkeypatch):
    """The huffman batch size and decoder follow `on_gpu()` at call
    time, not at import."""
    from tpulc.codecs.huffman import driver

    assert driver.max_batch() == 32
    _fake_devices(monkeypatch, "gpu")
    assert driver.max_batch() == 128
    calls = []
    monkeypatch.setattr(driver, "_decode_batch_walk",
                        lambda *a: calls.append("walk"))
    monkeypatch.setattr(driver, "_decode_batch_ranks",
                        lambda *a: calls.append("ranks"))
    driver.decode_batch_device(None, None, None, None, 128, 12)
    _fake_devices(monkeypatch, "cpu")
    driver.decode_batch_device(None, None, None, None, 128, 12)
    assert calls == ["walk", "ranks"]
