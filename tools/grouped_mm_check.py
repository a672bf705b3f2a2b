#!/usr/bin/env python3
"""What PyTorch's grouped product (`torch._grouped_mm`, the MoE dropless
dispatch's expert products in `repro_torch.models.moe`) does on this card
at deepseek-moe-16b's expert widths (64 experts, d 2048, d_expert 1408).

    python3 tools/grouped_mm_check.py

Prints one line per question, each answered on the card:

* bf16 with the stacked weights as the model holds them (row-major
  (d, f) per expert, a view of the (L, E, d, f) stack) and laid out
  column-major: does it run, does it equal one `x[a:b] @ w[e]` per group
  bit for bit, and its time (CUDA events over 20 calls after 3) at 36
  rows (a 6-token decode, top-6), 3072 rows (a 512-token chunk) and 7
  rows in 2 of 64 groups (group sizes not aligned to anything);
* f32: does it run eagerly, and can a CUDA graph capture it (a capture
  fails where the op reads its group offsets on the host);
* bf16 under capture: does the replay equal the eager call;
* `torch.bincount` on CUDA under capture (it reads its input's largest
  value on the host to size its output).

Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import torch

E, D, F = 64, 2048, 1408


def _per_group(x, w, ends):
    out, a = [], 0
    for e, b in enumerate(ends.tolist()):
        out.append(x[a:b] @ w[e])
        a = b
    return torch.cat(out)


def _ms(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    st = torch.cuda.Event(enable_timing=True)
    en = torch.cuda.Event(enable_timing=True)
    st.record()
    for _ in range(reps):
        fn()
    en.record()
    torch.cuda.synchronize()
    return st.elapsed_time(en) / reps


def _captures(fn):
    """(True, the replay's output equals an eager call's) or (False, the
    error's first line)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            out = fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        return False, str(e).splitlines()[0][:200]
    graph.replay()
    torch.cuda.synchronize()
    return True, torch.equal(out, fn())


def main() -> int:
    if not torch.cuda.is_available():
        print("grouped_mm_check: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"torch {torch.__version__} CUDA {torch.version.cuda}; {smi}")
    g = torch.Generator(device="cuda").manual_seed(0)
    stack = (torch.randn(2, E, D, F, device="cuda", generator=g)
             * 0.02).to(torch.bfloat16)
    w = stack[1]
    layouts = {"row-major": w,
               "col-major": w.transpose(1, 2).contiguous().transpose(1, 2)}
    for rows in (36, 3072, 7):
        if rows == 7:
            counts = torch.zeros(E, dtype=torch.int64)
            counts[3], counts[10] = 3, 4
        else:
            pick = torch.randint(0, E, (rows,),
                                 generator=torch.Generator().manual_seed(rows))
            counts = torch.bincount(pick, minlength=E)
        ends = torch.cumsum(counts, 0).to("cuda", torch.int32)
        x = torch.randn(rows, D, device="cuda", generator=g).to(
            torch.bfloat16)
        for name, ww in layouts.items():
            y = torch._grouped_mm(x, ww, offs=ends)
            ref = _per_group(x, ww, ends.cpu())
            ms = _ms(lambda: torch._grouped_mm(x, ww, offs=ends))
            print(f"bf16 {name} {rows} rows in {int((counts > 0).sum())} "
                  f"groups: equal to one product a group "
                  f"{torch.equal(y, ref)}, {ms:.4f} ms")
    x = torch.randn(36, D, device="cuda", generator=g)
    ends = torch.arange(1, E + 1, device="cuda", dtype=torch.int32) * 36 // E
    for dt in (torch.float32, torch.bfloat16):
        xx, ww = x.to(dt), w.to(dt)
        y = torch._grouped_mm(xx, ww, offs=ends)
        err = float((y.float() - _per_group(xx, ww, ends.cpu()).float())
                    .abs().max())
        ok, what = _captures(lambda: torch._grouped_mm(xx, ww, offs=ends))
        print(f"{dt} eager: max |diff| to one product a group {err:.3g}; "
              f"capture: " + (f"ok, replay equals eager {what}" if ok
                              else f"refused ({what})"))
    idx = torch.randint(0, E, (36,), device="cuda")
    ok, what = _captures(lambda: torch.bincount(idx, minlength=E))
    print("torch.bincount capture: " + ("ok" if ok else f"refused ({what})"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
