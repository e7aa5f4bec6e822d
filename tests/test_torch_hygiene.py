"""Import and device hygiene of the port.

The port (``src/repro_torch``) and ``chip_smoke.py`` import nothing of JAX
and nothing of the JAX package; the port imports, serves and trains
through ``Cluster.submit`` with JAX absent; its entry points run on CUDA unless the CPU is asked for, and
raise when there is no CUDA device instead of carrying on on the CPU.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.rmsnorm import rmsnorm

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"the port must not import JAX or repro: {bad}"


def test_port_imports_and_serves_with_jax_absent():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.launch.serve import serve\n"
            "out = serve(reduced=True, device='cpu', requests=2, "
            "max_batch=2, prompt_range=(20, 140), max_new=2, verbose=False)\n"
            "assert out['stats'].completed == 2\n"
            "assert out['plan'].mesh.name == 'h100'  # via Cluster.submit\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve(reduced=True, requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cpu_calls_take_the_plain_versions_and_count_no_launch():
    before = (rmsnorm.launches, paged_attention.launches,
              flash_attention_fwd.launches)
    x = torch.randn(3, 16)
    rmsnorm(x, torch.zeros(16))
    q = torch.randn(1, 2, 1, 16)
    flash_attention_fwd(q, q, q)
    paged_attention(torch.randn(1, 2, 16), torch.randn(2, 8, 2, 16),
                    torch.randn(2, 8, 2, 16),
                    torch.tensor([[0]], dtype=torch.int32),
                    torch.tensor([3], dtype=torch.int32))
    assert (rmsnorm.launches, paged_attention.launches,
            flash_attention_fwd.launches) == before


def test_kernel_build_is_keyed_by_source_hash(tmp_path, monkeypatch):
    """A changed source gets a new library name (never a stale load), and
    a build without ``nvcc`` fails loudly."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.lib_path("k")
    assert first == _build.lib_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build.lib_path("k") != first
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["k"])


def test_every_cuda_source_is_built():
    names = {p.stem for p in (PORT / "csrc").glob("*.cu")}
    assert names == set(_build.CUDA_SOURCES)


def test_port_trains_with_jax_absent():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.launch.train import train\n"
            "out = train(reduced=True, device='cpu', steps=2, verbose=False)\n"
            "assert len(out['metrics']) == 2\n"
            "assert out['plan'].mesh.name == 'h100'  # via Cluster.submit\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_train_raises_without_cuda(monkeypatch):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(reduced=True, steps=1, verbose=False)


def test_cpu_gradients_take_the_plain_versions_and_count_no_launch():
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     flash_attention_bwd_dkv,
                                                     flash_attention_bwd_dq)
    from repro_torch.kernels.rmsnorm import RMSNorm
    counters = (flash_attention_fwd, flash_attention_bwd_dq,
                flash_attention_bwd_dkv, rmsnorm)
    before = [fn.launches for fn in counters]
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    FlashAttention.apply(q, q, q, True, 0, 0).sum().backward()
    x = torch.randn(3, 16, requires_grad=True)
    RMSNorm.apply(x, torch.zeros(16), 1e-6).sum().backward()
    assert q.grad is not None and x.grad is not None
    assert [fn.launches for fn in counters] == before
