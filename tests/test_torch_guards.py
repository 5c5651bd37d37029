"""Guards on how the port meets the card's machine, checked on the CPU.

That machine has Python, PyTorch with CUDA, the CUDA toolkit, numpy and
pytest, and none of JAX, Flax, Optax, PyYAML, Orbax, OpenCV, PIL,
torchvision, ninja or setuptools. The port and ``chip_smoke.py`` must
import without them, build their kernels with plain ``nvcc``, and fail
loudly without a card.
"""

import os
import shutil
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from odtpu_torch.ops.cuda import build

ROOT = Path(__file__).resolve().parents[1]

_REFUSED = ("jax", "jaxlib", "flax", "optax", "yaml", "orbax", "cv2", "PIL",
            "torchvision", "ninja", "setuptools",
            "torch.utils.cpp_extension", "odtpu")


def _run(code, cwd=ROOT, env=None, timeout=240):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_chip_smoke_import_without_refused_modules():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        REFUSED = {refused!r}

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if any(name == r or name.startswith(r + ".")
                       for r in REFUSED):
                    raise ImportError("refused: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import odtpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            odtpu_torch.__path__, "odtpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # the model zoo: every family's module
        for family in ("drn", "drnssd", "fpn", "fssd", "refinedet",
                       "rfbnet"):
            assert "odtpu_torch.models." + family in names, family
        # int8 serving, the HTTP server, the export entry point and the
        # weight tools
        for module in ("odtpu_torch.ops.quant", "odtpu_torch.serve",
                       "odtpu_torch.export", "odtpu_torch.tools.ckpt_to_npz",
                       "odtpu_torch.tools.convert_torch_weights"):
            assert module in names, module
        import chip_smoke
        leaked = [m for m in sys.modules
                  if any(m == r or m.startswith(r + ".") for r in REFUSED)]
        assert not leaked, leaked
        print(len(names), "modules")
    """).format(refused=_REFUSED)
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[0]) >= 36


def test_chip_smoke_without_cuda_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "is_available() is false" in proc.stderr


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_nvcc_command_targets_hopper_shared_library():
    cmd = build.nvcc_command("nvcc", Path("k.cu"), Path("k.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    for flag in ("-shared", "-O3", "-std=c++17", "-fPIC"):
        assert flag in cmd
    assert cmd[-3:] == ["-o", "k.so", "k.cu"]
    assert "-v" not in cmd
    assert build.nvcc_flags(verbose=True)[-2:] == ["-Xptxas", "-v"]


def test_library_path_is_keyed_on_source():
    path = build.library_path("nms_kernel")
    assert path.parent == ROOT / "build" / "odtpu_torch"
    assert path.name.startswith("nms_kernel-") and path.suffix == ".so"
    assert (build.CSRC / "nms_kernel.cu").is_file()


def _fake_nvcc(tmp_path, body):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return nvcc


def test_build_uses_cuda_home_and_caches(tmp_path, monkeypatch):
    # a stand-in nvcc that writes its -o argument and counts its calls
    calls = tmp_path / "calls"
    nvcc = _fake_nvcc(tmp_path, textwrap.dedent("""
        echo x >> {calls}
        while [ "$1" != "-o" ]; do shift; done
        echo lib > "$2"
    """).format(calls=calls))
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parents[1]))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    assert build.find_nvcc() == str(nvcc)
    path, _, _ = build.build("nms_kernel")
    assert path.read_text() == "lib\n"
    again, seconds, _ = build.build("nms_kernel")
    assert again == path and seconds == 0.0
    assert calls.read_text().count("x") == 1
    build.build("nms_kernel", verbose=True)  # always compiles
    assert calls.read_text().count("x") == 2


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no sm_90a here' >&2\nexit 1\n")
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parents[1]))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        build.build("nms_kernel")
    assert not list((tmp_path / "out").iterdir())
