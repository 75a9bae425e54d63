#!/usr/bin/env python3
"""Where a launch of the scheduled slot step's warp variant spends its
time, on one NVIDIA card.

    python3 scripts/slot_step_probe.py      # from the root of a checkout

A copy of ``csrc/schedule_fire.cu`` with ``clock64()`` stamps in
``sched_slot_warp_kernel`` (slot 0's first thread: the pid window and
the registers landed with the slot's barrier; the pid window walked; the
feed windows landed with the barrier; then, summed over the working
cycles, the prefetch, the feed and its barrier, the fire and its barrier,
the drain and the register moves; the end) is built into ``build/probe/``
(``scripts/sched_run_probe.py``'s build) and launched through the port's
wrapper at the scheduled serving state of ``chip_smoke.py`` (dot_prod n =
32, B = 1024 slots, K = 64; the first active slot moved to slot 0), and
with that slot alone (the floor's shape).
Prints the device time and the SM clocks of each phase.  The card's name
and power limit come first.  Needs a card; nothing of the port's results
depends on it.
"""
from __future__ import annotations

import ctypes
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

AFTER = "sched_slot_warp_kernel(const int2*"
PHASES = ("pids and registers landed", "walked the pid window",
          "windows landed", "prefetch", "feed", "fire", "drain")
# (anchor in the slot kernel, text put in its place)
STAMPS = (
    ("  int* s_pid = smem + local * slot_stream_ints(d);",
     "  const long long q0 = clock64();\n"
     "  int* s_pid = smem + local * slot_stream_ints(d);"),
    ("  // the pid window, once: tokens per feed row, and the cycles that",
     "  const long long q1 = clock64();\n"
     "  // the pid window, once: tokens per feed row, and the cycles that"),
    ("  // each feed row's window, by its own thread\n",
     "  const long long q2 = clock64();\n"
     "  // each feed row's window, by its own thread\n"),
    ("  // a token's slot in the windows, for the row's clamped pointer",
     "  const long long q3 = clock64();\n"
     "  long long acc[4] = {0, 0, 0, 0};\n"
     "  // a token's slot in the windows, for the row's clamped pointer"),
    ("    // the next working cycle's entries, off the chain",
     "    const long long c0 = clock64();\n"
     "    // the next working cycle's entries, off the chain"),
    ("    // 1. feed\n", "    const long long c1 = clock64();\n"
                       "    // 1. feed\n"),
    ("    __syncwarp();\n    // 2. fire",
     "    __syncwarp();\n    const long long c2 = clock64();\n"
     "    // 2. fire"),
    ("    __syncwarp();\n    // 3. drain",
     "    __syncwarp();\n    const long long c3 = clock64();\n"
     "    // 3. drain"),
    ("    lb = nlb;\n  }\n  // the last cycle's writes",
     "    lb = nlb;\n    const long long c4 = clock64();\n"
     "    acc[0] += c1 - c0; acc[1] += c2 - c1; acc[2] += c3 - c2;\n"
     "    acc[3] += c4 - c3;\n  }\n  const long long q4 = clock64();\n"
     "  // the last cycle's writes"),
    ("      out_count_o[outs + r] = oc[k];\n    }\n  }\n}\n",
     "      out_count_o[outs + r] = oc[k];\n    }\n  }\n"
     "  if (b == 0 && t == 0) {\n"
     "    g_stamps[0] = q1 - q0; g_stamps[1] = q2 - q1;\n"
     "    g_stamps[2] = q3 - q2;\n"
     "    for (int i = 0; i < 4; ++i) g_stamps[3 + i] = acc[i];\n"
     "    g_stamps[7] = live; g_stamps[8] = q4 - q3;\n"
     "    g_stamps[9] = clock64() - q4;\n  }\n}\n"),
)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("slot_step_probe: no CUDA device", file=sys.stderr)
        return 1
    import numpy as np
    from chip_smoke import card_line, device_ms
    from norm_sched_probe import slot_serving_state
    from repro_torch.kernels import _build
    from repro_torch.kernels import schedule_fire as ksf
    from sched_run_probe import build
    print(card_line(), flush=True)
    lib = build(STAMPS, n=10, after=AFTER, tag="slot")
    _build.load = lambda: lib          # the wrapper launches the stamped copy
    dev = torch.device("cuda")
    tabs, args, st, ctx = slot_serving_state(dev)
    b0 = int(np.nonzero(st.active)[0][0])
    order = [b0] + [b for b in range(st.slots) if b != b0]
    moved = [x[order] for x in args]
    cases = (("B=1024", moved), (f"slot {b0} alone", [x[:1] for x in moved]))
    for tag, a in cases:
        run = lambda: ksf.launch_slot_variant("warp", tabs, *a)
        ms = device_ms(run, 5, "sched_slot_warp")
        s = (ctypes.c_longlong * 10)()
        lib.sched_stamps(s)
        live = max(s[7], 1)
        print(f"dot_prod serving state, {tag} "
              f"({ksf.sched_slot_step_cuda.last_plan['streams']} slots a "
              f"CTA): {ms:.4f} ms; slot 0's SM clocks: "
              + ", ".join(f"{p} {s[i]}" for i, p in enumerate(PHASES[:3]))
              + f"; {s[7]} working cycles, per cycle: "
              + ", ".join(f"{p} {s[3 + i] / live:.1f}" for i, p in
                          enumerate(PHASES[3:]))
              + f"; loop {s[8]}, stores {s[9]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
