"""The NEE depth cap on the second light topology: a small emitter seen
through a doorway.

Port of ``tools/sweep_pt19.py``. ``sweep_pt17`` measures the cap on the
atrium, whose emitters are large ceiling panels that most first-bounce
vertices see directly; this runs the same protocol on ``make_tworooms``
(150k triangles with its materials, leaves of up to 24): a dark room lit
only through a doorway by a recessed fixture in the next room, where first
vertices almost never see the emitter and the light arrives over several
bounces. Each cap (default none, 3, 2, 1; ``--caps``) renders 960x540 @ 8
spp, 7 bounces, no environment, over K2: one warm-up and five timed frames,
six seeds (``common.cap_sweep``), with the same gate: each capped row's mean
within 1% of the first capped row's, or within 4 standard errors of their
difference, which here, with a small emitter seen over several bounces, is
the wider (the JAX tool asserted 5% of the uncapped row's).

The JSON line has the keys of the JAX-era ``SWEEP_NEE_CAP2.json``; ``--out``
writes it, and nothing else is written.

Usage: ``python -m minipath_tpu_torch.tools.sweep_pt19 [--device cuda] [--out
PATH] [--caps none,3,2,1] [W H spp]``
"""

from __future__ import annotations

import sys

from minipath_tpu_torch.tools import common

SIZE = (960, 540, 8)
BOUNCES = 7
SEEDS = 6
CAPS = "none,3,2,1"
TWOROOMS_TRIANGLES = 150_000
LEAF_MAX = 24


def camera():
    """In the dark room, facing the doorway."""
    from minipath_tpu_torch.camera import Camera

    return Camera().look_at((-10.0, 3.0, 0.0), (0.0, 1.5, 0.0)).f_number(8.0).sensor_width(36e-3)


def main(argv=None) -> int:
    p = common.parser("The NEE depth cap on the two-rooms scene, by Monte-Carlo efficiency.",
                      "W H spp (default 960 540 8)")
    p.add_argument("--caps", type=common.caps, default=common.caps(CAPS), metavar="C,...",
                   help=f"NEE depth caps, 'none' for no cap (default {CAPS})")
    args = p.parse_args(argv)
    W, H, SPP = common.sizes(args, p, SIZE)
    device = common.device_or_none(args)
    if device is None:
        return 2

    from minipath_tpu_torch.scene.materials import Environment, table_from_numpy

    built = common.cached_scene("tworooms", TWOROOMS_TRIANGLES, materials=True, leaf_max=LEAF_MAX)
    bvh = built.bvh
    w = common.pt_workload(bvh.host_arrays, table_from_numpy(built.material_fields, device),
                           bvh.recommended_stack_size, device)
    failed = []
    rows = common.cap_sweep(w, camera().build_sampler((W, H), device), Environment.none(device), args.caps,
                            width=W, height=H, spp=SPP, bounces=BOUNCES, seeds=SEEDS, failed=failed)
    out = {
        "device": common.device_name(device),
        "workload": f"tworooms (recessed occluded emitter, {bvh.build_result.triangle_count} triangles) {W}x{H} @ "
                    f"{SPP}spp, {BOUNCES} bounces, {SEEDS} seeds, K2 over the f32 layout",
        "rows": rows,
        "kernel_launches": common.kernel_launches(),
        "gates_failed": failed,
    }
    return common.finish(out, args.out)


if __name__ == "__main__":
    sys.exit(main())
