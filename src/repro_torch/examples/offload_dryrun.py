"""LayerKV at pod scale: the KV cache placed in host memory — the port of
`examples/offload_dryrun.py`.

Runs the chatglm3-6b `decode_32k` step twice on the 16x16 placeholder
mesh (`launch.dryrun`): the baseline (all KV in device memory), and with
the cache's `k` / `v` leaves placed in pinned host memory (LayerKV-style
offload; `len` stays on the device), and prints the per-rank
device / host split with the offloadable KV per GPU from
`CostModel(cfg, H100)`, and each run's temporaries (`temp_size`, the
peak of a rank's live bytes in the step) and device total
(`bytes_per_device`). Unlike the reference's CPU stand-in, which folds
pinned_host into one memory space, the port's record gives the split
directly from the placements: the same step and the same bytes, only
counted on the other side.

    PYTHONPATH=src python -m repro_torch.examples.offload_dryrun

Run it as a fresh process: the dry run starts a process group.
"""
from __future__ import annotations

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.dryrun import run_one
from repro_torch.serving.costmodel import H100, CostModel

ARCH, SHAPE = "chatglm3-6b", "decode_32k"
HOST_KEYS = ("k", "v")   # offload the KV stacks, keep len on device


def lower_decode(offload: bool) -> dict:
    """The dry-run record of the decode step (raises if it failed)."""
    rec = run_one(ARCH, SHAPE, False,
                  host_keys=HOST_KEYS if offload else ())
    if not rec["ok"]:
        raise RuntimeError(f"{ARCH} x {SHAPE}: {rec['error']}")
    return rec


def kv_per_gpu() -> float:
    """The KV cache bytes one of the 256 GPUs holds at decode_32k."""
    shp = SHAPES[SHAPE]
    cm = CostModel(get_config(ARCH), H100)
    return cm.kv_bytes(shp.seq_len) * shp.global_batch / 256


def main():
    base = lower_decode(offload=False)
    off = lower_decode(offload=True)
    gib = 2**30
    print(f"{ARCH} {SHAPE} on 16x16 (256 GPUs):")
    for tag, r in (("baseline", base),
                   ("layerkv (KV in pinned host memory)", off)):
        m = r["memory"]
        print(f"  {tag}: args/GPU device {m['argument_size']/gib:6.2f} GiB"
              f", host {m['host_argument_size']/gib:6.2f} GiB; "
              f"temporaries {m['temp_size']/gib:6.2f} GiB (host "
              f"{m['host_temp_size']/gib:.2f}); device total "
              f"{r['bytes_per_device']/gib:6.2f} GiB")
    print(f"  KV cache per GPU (the offloadable share): "
          f"{kv_per_gpu()/gib:.2f} GiB")
    return base, off


if __name__ == "__main__":
    main()
