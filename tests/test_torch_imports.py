"""The port stands alone: no module of `repro_torch`, nor `chip_smoke.py`,
imports `jax` or anything of the JAX package `repro` — checked both at
run time (a fresh interpreter imports them all) and statically (an AST
scan of every import and every `importlib` module string). And its entry
points run on the card unless told otherwise: without CUDA they raise
rather than fall back to the CPU."""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
FILES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    out = []
    for f in sorted(PKG.rglob("*.py")):
        parts = f.relative_to(PKG.parent).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def _is_forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") \
        or name == "repro" or name.startswith("repro.")


def test_importing_every_module_pulls_in_no_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(REPO / 'src')!r}, {str(REPO)!r}]\n"
        f"for m in {_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "import repro_torch.configs as c\n"
        "c.get_config('llama2-7b'); c.get_smoke_config('granite-3-2b')\n"
        "import repro_torch.obs as o\n"
        "o.Tracer, o.write_trace\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith('jax.') or n == 'repro'\n"
        "             or n.startswith('repro.'))\n"
        "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=REPO, timeout=300,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith(("repro.", "jax")) \
                and " " not in node.value:
            names = [node.value]          # importlib module strings
        elif isinstance(node, ast.JoinedStr):
            head = node.values[0] if node.values else None
            if isinstance(head, ast.Constant) \
                    and str(head.value).startswith("repro."):
                names = [str(head.value)]
        for n in names:
            assert not _is_forbidden(n), f"{path}:{node.lineno} imports {n}"


def _cfg():
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("granite-3-2b"),
                               dtype="float32")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from repro_torch.models import DecoderModel
    from repro_torch.serving.engine import LayerKVEngine
    from repro_torch.serving.executor import PagedExecutor
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import train
    from repro_torch.weights import from_jax_params
    cfg = _cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LayerKVEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedExecutor(cfg, None, 8, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderModel(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_jax_params({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(cfg, DataConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, steps=1)
    # asking for the CPU is the only way onto it
    assert PagedExecutor(cfg, None, 8, 8, 8, device="cpu").device.type \
        == "cpu"


def test_serve_cli_raises_without_cuda_and_rejects_unported(no_cuda):
    """Without CUDA the CLI raises, with one replica or several (every
    flag of the reference's CLI is ported, so none is rejected)."""
    from repro_torch.launch import serve
    for flags in ([], ["--replicas", "2", "--fault-plan", "random:1"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--arch", "granite-3-2b", "--smoke", "--requests",
                        "1", *flags])


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                "--requests", "3", "--prompt-len", "24", "--output-len",
                "4", "--device-blocks", "16", "--quiet"])
    out = capsys.readouterr().out
    assert "served=3" in out and "device=cpu" in out


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-moe-16b"])
def test_serve_cli_runs_fused_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--fused",
                "--requests", "4", "--prompt-len", "40", "--output-len",
                "4", "--device-blocks", "30", "--quiet"])
    out = capsys.readouterr().out
    assert "served=4" in out and "chunked=True fused=True" in out


def test_chip_smoke_refuses_without_cuda(no_cuda, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out
