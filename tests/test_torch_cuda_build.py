"""PyTorch port: the CUDA kernel build raises on failure and never falls
back; the launch counters count only launches.  (The kernels themselves run
only on a GPU: ``chip_smoke.py`` builds and checks them there.)"""

import os
import stat

import pytest

from portello_tpu_torch.kernels import _cuda


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_cuda, "SO_PATH", str(tmp_path / "_build" / "lib.so"))
    return tmp_path


def _fake_nvcc(tmp_path, body):
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return str(home)


def test_failed_nvcc_build_raises_with_stderr(build_dir, monkeypatch):
    home = _fake_nvcc(build_dir, "echo 'error: bad kernel' >&2\nexit 1\n")
    monkeypatch.setenv("CUDA_HOME", home)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _cuda.build()
    assert not os.path.exists(_cuda.SO_PATH)
    assert os.listdir(_cuda.BUILD_DIR) == []  # no half-written library


def test_build_passes_sm90a_flags_and_publishes(build_dir, monkeypatch):
    # the fake compiler appends its arguments (one line per process) and
    # writes the -o target
    log = build_dir / "args.txt"
    home = _fake_nvcc(
        build_dir,
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n',
    )
    monkeypatch.setenv("CUDA_HOME", home)
    _cuda.build()
    calls = log.read_text().splitlines()
    # one compile per source, then one link
    assert len(calls) == len(_cuda.SOURCES) + 1
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    assert "window_match.cu" in _cuda.SOURCES
    for src in _cuda.SOURCES:
        assert any(os.path.join(_cuda.CSRC, src) in c and " -c " in c
                   for c in calls[:-1])
    assert "-shared" in calls[-1]
    assert os.path.exists(_cuda.SO_PATH)
    assert os.listdir(_cuda.BUILD_DIR) == [os.path.basename(_cuda.SO_PATH)]
    assert not _cuda._stale()


def test_missing_nvcc_raises(build_dir, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(build_dir / "nowhere"))
    monkeypatch.setenv("PATH", str(build_dir / "empty"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build()


def test_launch_counts_count_only_successful_launches():
    _cuda.reset_launch_counts()
    _cuda.check(0, "match_run")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _cuda.check(700, "cleanup_and_compress")
    _cuda.check(0, "window_match")
    _cuda.check(0, "window_match")
    assert _cuda.launch_counts == {
        "cleanup_and_compress": 0, "match_run": 1, "window_match": 2,
    }
    _cuda.reset_launch_counts()
    assert set(_cuda.launch_counts.values()) == {0}
