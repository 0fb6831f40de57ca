"""The platform decision, the compile-cache helper, and the device gates of
the measurement entry points (chip_smoke.py, bench.py)."""

import json
import os
import types

import jax
import pytest


def test_device_path_is_cpu_here():
    from ssrlcv_tpu.backend import device_path

    assert device_path() == "cpu"
    assert device_path(jax.devices("cpu")[0]) == "cpu"


@pytest.mark.parametrize("platform", ["rocm", "metal"])
def test_device_path_rejects_unknown_platforms(platform):
    from ssrlcv_tpu.backend import device_path

    with pytest.raises(RuntimeError, match=platform):
        device_path(types.SimpleNamespace(platform=platform))


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    from ssrlcv_tpu import backend

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(backend.__file__))), ".jax_cache")
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
        # the same directory every time: no temporary name, pid or time
        assert backend.enable_compile_cache() == want
        assert backend.enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_measurements_refuse_the_cpu():
    import bench
    import chip_smoke

    from ssrlcv_tpu.backend import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    with pytest.raises(RuntimeError):
        chip_smoke.result_line(jax.devices())


def test_result_line_has_exactly_the_contract_keys():
    import chip_smoke

    card = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([card] * 4)
    out = json.loads(line)
    assert out == {"ok": True, "device": {"platform": "gpu",
                                          "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_card_line_parser():
    from ssrlcv_tpu.backend import parse_card_line

    assert parse_card_line("NVIDIA H100 80GB HBM3, 700.00 W\n") == (
        "NVIDIA H100 80GB HBM3", "700.00 W")
    assert parse_card_line("Some, Card, 350.00 W") == ("Some, Card", "350.00 W")
    for bad in ("", "no comma here", "name only, ", ", 700 W"):
        with pytest.raises(ValueError):
            parse_card_line(bad)


def test_card_query_fails_without_nvidia_smi(monkeypatch, tmp_path):
    from ssrlcv_tpu.backend import card_lines

    monkeypatch.setenv("PATH", str(tmp_path))  # an empty directory
    with pytest.raises(RuntimeError, match="nvidia-smi"):
        card_lines()
