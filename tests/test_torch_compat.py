"""Device resolution and the kernel build of the port, as far as a machine
without a card can check them."""
import pytest
import torch

from repro_torch import compat
from repro_torch.kernels import _build, ops


def test_cpu_resolves_everywhere():
    assert compat.resolve_device("cpu") == torch.device("cpu")
    assert compat.resolve_device(torch.device("cpu")) == torch.device("cpu")


def test_default_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        assert compat.resolve_device(None).type == "cuda"
        return
    assert compat.device_capability() is None and not compat.is_sm90()
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compat.resolve_device(dev)


def test_other_device_types_are_rejected():
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        compat.resolve_device("meta")


def test_build_without_nvcc_raises_and_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_names_follow_the_sources():
    paths = {_build._lib_path(name) for name in _build.KERNELS}
    assert len(paths) == len(_build.KERNELS)
    for name in _build.KERNELS:
        assert (_build.CSRC_DIR / f"{name}.cu").is_file()
        path = _build._lib_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_launch_counters_reset_and_credit():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"window_score": 0, "segment_sum": 0, "flash_attention": 0}
    ops.credit_replays({"window_score": 3}, 5)
    assert ops.launch_counts() == {"window_score": 15, "segment_sum": 0, "flash_attention": 0}
    ops.reset_launch_counts()
    assert ops.launch_counts()["window_score"] == 0
