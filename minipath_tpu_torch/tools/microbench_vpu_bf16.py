"""Does the card run packed bf16 elementwise ops faster than f32?

Port of ``tools/microbench_vpu_bf16.py``. The traversal kernels are bound on
slab-test min/max/mul chains. If the card retires packed bf16 (``bf16x2``)
at twice the f32 rate, a conservative bf16 box layout could halve that
arithmetic; if not, the idea is dead. This times a register-resident
min/max/mul chain at both types, the slab test's op mix, isolated from
memory traffic, through the chain kernel of ``csrc/chain.cu`` (K5: one f32
element, or one pair of bf16 elements, a thread).

At the default shape the chain is about 34 M lane-operations, a microsecond
of the card's work, so there it measures launch overhead; ``run`` takes
``shape`` and ``iters`` for a size that fills the card.

In bf16 the constant ``1.0009765625`` rounds to 1.0 (bf16 keeps 8
significant bits), so ``b == a`` there, in the JAX tool as here.

Usage: ``python -m minipath_tpu_torch.tools.microbench_vpu_bf16 --device cuda``
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from minipath_tpu_torch.utils.calibrate import CHAIN_OPS_PER_STEP, chain_input, synchronize, vpu_chain


def run(dtype, shape=(256, 128), iters=256, reps=200, device="cuda"):
    """Mean seconds of one chain call over ``reps`` calls after one warm
    call (``reps + 1`` launches on a card); prints the rate."""
    device = torch.device(device)
    x = chain_input(shape, dtype, device)
    vpu_chain(x, iters)  # build and warm
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = vpu_chain(x, iters)
    synchronize(device)
    dt = (time.perf_counter() - t0) / reps
    del y
    ops = shape[0] * shape[1] * iters * CHAIN_OPS_PER_STEP  # 3 mul + min + max
    print(f"{str(dtype).removeprefix('torch.'):9s}: {dt*1e6:8.1f} us/call  {ops/dt/1e9:8.1f} Gop/s", flush=True)
    return dt


def main(argv=None):
    parser = argparse.ArgumentParser(description="The chain at f32 and bf16: does bf16x2 run faster?")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device (default cuda)")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"devices: [{name}]", flush=True)
    t_f32 = run(torch.float32, device=device)
    t_bf16 = run(torch.bfloat16, device=device)
    print(f"bf16 speedup over f32: {t_f32/t_bf16:.2f}x", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
