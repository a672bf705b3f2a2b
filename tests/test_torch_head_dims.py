"""Every head dim the port runs has a kernel on the card, checked on the
CPU. Flash (forward, backward and `decode_attention`) serves every
family with attention (dense, MoE, vlm, encdec, hybrid), full and smoke:
each config's head dim is in flash's `_HEAD_DIMS`, which now holds
zamba2's 80. The paged kernels serve only the families `PagedExecutor`
runs (dense, MoE): their wrappers keep a list of their own, without 80,
so a paged call at D = 80 raises before any launch. Each source's C
entry point has a case for every head dim of its own list in both
dtypes (read from the `dtype == N && D == NN` cases of its source). A
head dim outside either makes a CUDA tensor raise; the plain versions
take any, so the other CPU tests never show it. The route of each case
is read there too: in both flash sources bf16 at D 64, 80 and 128 takes
the bf16 tensor-core kernels (the `*_TC_CASE` macro), f32 at every D and
bf16 at D 32 the 3xTF32 kernels (the `*_TF32_CASE` macro), and no
CUDA-core attention template is left in either."""
import importlib
import pathlib
import pkgutil
import re

import pytest

import repro_torch.configs
from repro_torch.kernels import flash_prefill, paged_attention, paged_prefill

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src/repro_torch/csrc"
SERVED = ("dense", "moe")     # serving/executor.py: decoder-only families
FLASH_DIMS = (32, 64, 80, 128)
PAGED_DIMS = (32, 64, 128)
# each attention source and the head dims its dispatch must cover
ATTENTION_SOURCES = {"flash_prefill.cu": FLASH_DIMS,
                     "flash_backward.cu": FLASH_DIMS,
                     "paged_attention.cu": PAGED_DIMS,
                     "paged_prefill.cu": PAGED_DIMS}
# every config module of the package (ARCH_IDS leaves out llama2-7b)
CONFIGS = {m.name: importlib.import_module(f"repro_torch.configs.{m.name}")
           for m in pkgutil.iter_modules(repro_torch.configs.__path__)
           if m.name != "base"}
SERVED_ARCHS = sorted(n for n, m in CONFIGS.items()
                      if m.CONFIG.family in SERVED)
ATTENTION_ARCHS = sorted(n for n, m in CONFIGS.items()
                         if m.CONFIG.family != "ssm")


def _cfg(arch, size):
    return CONFIGS[arch].CONFIG if size == "full" else CONFIGS[arch].SMOKE


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_served_config_head_dim_has_a_kernel(arch, size):
    cfg = _cfg(arch, size)
    assert cfg.family in SERVED
    assert cfg.resolved_head_dim in paged_attention._HEAD_DIMS, (
        f"{cfg.arch_id}: head dim {cfg.resolved_head_dim} not in "
        f"{paged_attention._HEAD_DIMS}")


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_attention_config_head_dim_has_a_flash_kernel(arch, size):
    """Every family with attention runs flash (prefill, training) and
    `decode_attention` (its decode) at its head dim: zamba2-2.7b at 80."""
    cfg = _cfg(arch, size)
    assert cfg.family in ("dense", "moe", "vlm", "encdec", "hybrid")
    assert cfg.resolved_head_dim in flash_prefill._HEAD_DIMS, (
        f"{cfg.arch_id}: head dim {cfg.resolved_head_dim} not in "
        f"{flash_prefill._HEAD_DIMS}")


def test_wrapper_head_dim_lists():
    """Flash's list takes 80; the paged wrappers read a list of their own
    (one for both) that has no 80, so they refuse D = 80 before any
    launch (their sources have no case for it)."""
    assert flash_prefill._HEAD_DIMS == FLASH_DIMS
    assert paged_attention._HEAD_DIMS == PAGED_DIMS
    assert paged_prefill._HEAD_DIMS is paged_attention._HEAD_DIMS
    assert 80 not in paged_attention._HEAD_DIMS
    assert CONFIGS["zamba2_2_7b"].CONFIG.resolved_head_dim == 80


@pytest.mark.parametrize("source", list(ATTENTION_SOURCES))
def test_kernel_dispatch_covers_every_head_dim(source):
    text = (CSRC / source).read_text()
    cases = {(int(t), int(d)) for t, d in
             re.findall(r"dtype == (\d) && D == (\d+)\)", text)}
    want = {(t, d) for t in (0, 1) for d in ATTENTION_SOURCES[source]}
    assert want <= cases, f"{source}: no case for {sorted(want - cases)}"
    assert {d for _, d in cases} <= set(ATTENTION_SOURCES[source]), (
        f"{source}: a case outside its wrapper's list")


def _routes(text):
    """{(dtype, D): the macro of that case} of a source's C entry."""
    return {(int(t), int(d)): m for t, d, m in re.findall(
        r"if \(dtype == (\d) && D == (\d+)\) (REPRO_\w+)\(", text)}


# each flash source's macro of the bf16 tensor-core case and of the
# 3xTF32 case
FLASH_MACROS = {"flash_prefill.cu": ("REPRO_FLASH_TC_CASE",
                                     "REPRO_FLASH_TF32_CASE"),
                "flash_backward.cu": ("REPRO_FLASH_BWD_TC_CASE",
                                      "REPRO_FLASH_BWD_TF32_CASE")}


@pytest.mark.parametrize("source", list(ATTENTION_SOURCES))
def test_bf16_d80_route(source):
    """bf16 at D 80 dispatches to the tensor-core case in both flash
    sources (f32 at D 80 and bf16 at D 32 take the 3xTF32 case, and no
    bf16 CUDA-core template at D 80 is instantiated); the paged sources
    have no D 80 at all."""
    text = (CSRC / source).read_text()
    if source.startswith("paged"):
        dims = {int(d) for d in re.findall(r"dtype == \d && D == (\d+)\)",
                                           text)}
        assert dims and 80 not in dims, dims
        assert not re.search(r"\b80\s*>", text), (
            f"{source}: instantiates a D = 80 template")
        return
    routes = _routes(text)
    tc, tf32 = FLASH_MACROS[source]
    assert routes[(1, 80)] == tc
    assert routes[(1, 64)] == routes[(1, 128)] == tc
    assert routes[(0, 80)] == routes[(1, 32)] == tf32
    assert all(m != tc for (t, _), m in routes.items() if t == 0)
    assert not re.search(r"__nv_bfloat16,\s*80\b", text), (
        f"{source}: a bf16 CUDA-core instantiation at D = 80 is left")


@pytest.mark.parametrize("source", list(FLASH_MACROS))
def test_f32_and_d32_routes_take_3xtf32(source):
    """Every f32 head dim and bf16 at D 32 dispatch to the 3xTF32 case in
    both flash sources, whose macro launches the tensor-core `tf::`
    kernels; bf16 at D 64 / 80 / 128 keep the bf16 tensor-core case; and
    no CUDA-core attention template (`flash_fwd_kernel<`,
    `flash_bwd_dq_kernel<`, `flash_bwd_dkdv_kernel<`) is left."""
    text = (CSRC / source).read_text()
    routes = _routes(text)
    tc, tf32 = FLASH_MACROS[source]
    for d in FLASH_DIMS:
        assert routes[(0, d)] == tf32, (source, d, routes[(0, d)])
    assert routes[(1, 32)] == tf32
    assert {d: routes[(1, d)] for d in (64, 80, 128)} == \
        {64: tc, 80: tc, 128: tc}
    macro = re.search(rf"#define {tf32}\(.*?\n(.*?)\n\s*if", text,
                      re.S).group(1)
    assert "tf::launch" in macro, macro
    kernels = ("flash_fwd_tf32",) if source == "flash_prefill.cu" \
        else ("flash_bwd_dq_tf32", "flash_bwd_dkdv_tf32")
    for name in kernels:
        assert re.search(rf"\b{name}\s*\(", text), name
    left = re.findall(r"\b(flash_fwd_kernel|flash_bwd_dq_kernel|"
                      r"flash_bwd_dkdv_kernel)\s*<", text)
    assert not left, f"{source}: CUDA-core templates left: {left}"
