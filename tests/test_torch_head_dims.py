"""Every head dim the port serves has a kernel on the card, checked on the
CPU: each dense or MoE config (the families `PagedExecutor` runs), full
and smoke, has its head dim in the wrappers' `_HEAD_DIMS`, and each of
the four attention kernels' C entry points has a case for every one of
those head dims in both dtypes (read from the `dtype == N && D == NN`
cases of its source). A head dim outside either makes a CUDA tensor
raise; the plain versions take any, so the other CPU tests never show
it."""
import importlib
import pathlib
import pkgutil
import re

import pytest

import repro_torch.configs
from repro_torch.kernels.flash_prefill import _HEAD_DIMS

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
SERVED = ("dense", "moe")     # serving/executor.py: decoder-only families
ATTENTION_SOURCES = ("flash_prefill.cu", "flash_backward.cu",
                     "paged_attention.cu", "paged_prefill.cu")
# every config module of the package (ARCH_IDS leaves out llama2-7b)
CONFIGS = {m.name: importlib.import_module(f"repro_torch.configs.{m.name}")
           for m in pkgutil.iter_modules(repro_torch.configs.__path__)
           if m.name != "base"}
SERVED_ARCHS = sorted(n for n, m in CONFIGS.items()
                      if m.CONFIG.family in SERVED)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_served_config_head_dim_has_a_kernel(arch, size):
    cfg = CONFIGS[arch].CONFIG if size == "full" else CONFIGS[arch].SMOKE
    assert cfg.family in SERVED
    assert cfg.resolved_head_dim in _HEAD_DIMS, (
        f"{cfg.arch_id}: head dim {cfg.resolved_head_dim} not in "
        f"{_HEAD_DIMS}")


@pytest.mark.parametrize("source", ATTENTION_SOURCES)
def test_kernel_dispatch_covers_every_head_dim(source):
    text = (CSRC / source).read_text()
    cases = {(int(t), int(d)) for t, d in
             re.findall(r"dtype == (\d) && D == (\d+)\)", text)}
    want = {(t, d) for t in (0, 1) for d in _HEAD_DIMS}
    assert want <= cases, f"{source}: no case for {sorted(want - cases)}"
