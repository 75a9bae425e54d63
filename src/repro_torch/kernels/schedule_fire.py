"""The static-schedule kernels: a whole scheduled run in one launch, and
K scheduled cycles per slot for the resumable slot API.

The counterparts of the JAX package's ``make_sched_run`` and
``make_sched_slot_step`` (``repro/kernels/schedule_fire.py``).  Both
read the same per-pattern tables (:meth:`ScheduleContext.slot_tables
<repro_torch.core.schedule.ScheduleContext.slot_tables>` plus each
pattern's fire count, the feed/drain arc rows and the const values).
One scheduled cycle of pattern ``pid`` is, as the JAX slot path's
``_slot_cycle`` computes it:

1. **feed** — every feed row with ``t_feed[pid, r]`` loads
   ``fv[r, clip(ptr[r], 0, L-1)]`` into its arc and advances its pointer;
2. **fire** — every fire row ``k`` of the pattern computes
   ``z = ALU(t_op, val[t_i0], val[t_i1])`` and writes it to ``t_o0`` and
   ``t_o1`` (the drop sentinel ``A2`` is skipped); a scheduled cycle's
   consumed and produced arcs are disjoint, so all reads see the
   post-feed registers;
3. **drain** — every output row with ``t_drain[pid, r]`` records the
   arc's value and counts a token.

pid 0 is the no-op pattern.  The run kernel starts each stream from the
const values and runs a program — the plan's clipped segments flattened
(:func:`flat_program`): segment offsets into a pid list, segment lengths
and repetitions.  The slot kernel runs ``pids[b, :]`` from the slot's
state and then sets ``full[b] = t_full[fsel[b]]`` unless ``fsel[b] ==
-1`` (an inactive slot rides pid 0 with ``fsel = -1``).

This module holds, side by side:

* :func:`device_sched_tables` — the tables on a device, bounds-checked,
  uploaded again whenever the pattern registry has grown since;
* the **plain PyTorch versions** :func:`sched_run` and
  :func:`sched_slot_step`;
* :func:`sched_run_staged` and :func:`sched_slot_step_staged`, the plain
  replays of the two kernels' warp variants: their feed windows (and the
  run's restaging cycle), the clamp, the alignment of each window's start
  and the slot step's skipped cycles (the tests hold them against the JAX
  package);
* the **kernel wrappers** :func:`sched_run_cuda` and
  :func:`sched_slot_step_cuda`: on CUDA tensors they launch the
  hand-written kernels of ``csrc/schedule_fire.cu`` (built at first use,
  see :mod:`repro_torch.kernels._build`) and count the launch; on CPU
  tensors they compute the plain version and build nothing.  The run
  kernel comes in two variants, chosen by :func:`sched_variant`: ``"warp"``
  (one or two warps per stream, up to four streams a CTA, the program and
  the tables staged in shared memory, feed windows staged ahead) for
  tables of at most :data:`WARP_ROWS` rows whose program fits the CTA's
  shared memory (:func:`warp_plan`), ``"cta"`` (one CTA per stream)
  otherwise; ``sched_run_cuda.launches_by`` counts each and
  ``sched_run_cuda.last_plan`` holds the plan of the last launch.  So
  does the slot kernel, by :func:`slot_variant`: ``"warp"`` (one warp
  per slot, up to four slots a CTA, the slot's registers, the
  cycles that do work and its feed windows staged once on chip) when the
  tables take it and one slot's windows fit a CTA (:func:`slot_plan`),
  ``"cta"`` otherwise; ``sched_slot_step_cuda.launches_by`` and
  ``.last_plan``.

The program and the pid windows are host data (numpy): the wrappers
check them on the host, on either device — every pid below the number of
patterns the tables hold, so a stale table raises instead of running a
no-op row — and copy them to the device with the launch (the slot step's
through a pinned buffer, one copy a launch).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.graph import Op
from repro_torch.kernels.dataflow_fire import (_CTRL_OPS, _alu_op,
                                               _check_tensors,
                                               _device_and_stream, _on_cpu,
                                               _smem_limit, _vp)

TABLE_KEYS = ("op", "i0", "i1", "o0", "o1", "feed", "drain", "full",
              "nfire", "ia", "oa", "val0")
PROGRAM_KEYS = ("seg_off", "seg_len", "seg_reps", "pids")
MAX_THREADS = 1024      # one thread per feed row, fire row and drain row
SCHED_VARIANTS = ("warp", "cta")
SLOT_VARIANTS = ("warp", "cta")
# the warp variant: the 32-row groups of each table a stream may take, and
# the largest A2 its packed fire words hold (13-bit operand indices)
WARP_ROW_GROUPS = (1, 2, 4)
WARP_ROWS = 32 * WARP_ROW_GROUPS[-1]
MAX_WARP_A2 = (1 << 13) - 1


class SchedTables(dict):
    """Device copies of the :data:`TABLE_KEYS` tables of a schedule
    context, checked on the host by :func:`device_sched_tables`:

      op, i0, i1, o0, o1 [P, F]   fire rows of each pattern (pad rows:
                                  COPY of FULL_PAD into the sentinel A2)
      feed [P, n_in], drain [P, n_out], full [P, A2]   0/1 rows
      nfire [P]                   fire rows of each pattern
      ia [n_in], oa [n_out]       arc of each feed / drain row
      val0 [A2]                   registers of a fresh run (const values)

    ``n_patterns`` is the registry length the upload covers (pids at or
    past it are stale), ``ops`` the opcodes of the real fire rows and
    ``warp`` the warp variants' packed tables (:func:`warp_tables`; None
    when the tables are too wide for them).  ``ops_mask`` (bit k: opcode
    k, COPY always) and ``ptrs`` (the tables' pointers, in
    :data:`TABLE_KEYS` order) are what every launch passes;
    ``slot_plans`` keeps the launcher's slot plans already asked for
    (:func:`slot_plan`)."""
    n_patterns = 0
    ops: tuple = ()
    warp = None
    ops_mask = 1 << int(Op.COPY)
    ptrs: tuple = ()


def host_sched_tables(ctx) -> dict:
    """The :data:`TABLE_KEYS` tables of ``ctx`` as int32 numpy arrays."""
    t_op, t_i0, t_i1, t_o0, t_o1, t_feed, t_drain, t_full = ctx.slot_tables()
    nfire = np.zeros((t_op.shape[0],), np.int32)
    nfire[:len(ctx.registry)] = [p.n_fires for p in ctx.registry]
    return dict(op=t_op, i0=t_i0, i1=t_i1, o0=t_o0, o1=t_o1, feed=t_feed,
                drain=t_drain, full=t_full, nfire=nfire, ia=ctx.ia_pad,
                oa=ctx.oa_pad, val0=ctx.state0_val())


def check_sched_tables(t: dict) -> tuple:
    """Raise unless the tables are consistent: shapes, fire indices
    (reads below A2, writes at most A2), 0/1 rows, fire counts within F,
    no control opcode.  Returns the opcodes of the real fire rows."""
    P, F = t["op"].shape
    A2 = t["val0"].shape[0]
    n_in, n_out = t["ia"].shape[0], t["oa"].shape[0]
    shapes = dict(op=(P, F), i0=(P, F), i1=(P, F), o0=(P, F), o1=(P, F),
                  feed=(P, n_in), drain=(P, n_out), full=(P, A2),
                  nfire=(P,), ia=(n_in,), oa=(n_out,), val0=(A2,))
    for k, shape in shapes.items():
        if t[k].shape != shape:
            raise ValueError(f"table {k}: shape {t[k].shape}, want {shape}")
    bounds = dict(i0=A2, i1=A2, o0=A2 + 1, o1=A2 + 1, feed=2, drain=2,
                  full=2, nfire=F + 1, ia=A2, oa=A2, op=len(Op))
    for k, hi in bounds.items():
        if t[k].size and (t[k].min() < 0 or t[k].max() >= hi):
            raise ValueError(f"table {k}: value outside [0, {hi})")
    real = np.arange(F)[None, :] < t["nfire"][:, None]
    ops = tuple(sorted({int(o) for o in t["op"][real]}))
    if any(o in _CTRL_OPS for o in ops):
        raise ValueError("a scheduled pattern fires a control operator")
    return ops


def warp_groups(n_in: int, F: int, n_out: int):
    """Groups of 32 rows a stream of the warp variant takes for tables of
    these widths (1, 2 or 4: its fire words per pattern are 32 times as
    many), or None when one is wider than :data:`WARP_ROWS`."""
    need = -(-max(n_in, F, n_out, 1) // 32)
    return next((g for g in WARP_ROW_GROUPS if g >= need), None)


def warp_tables(t: dict):
    """The warp variant's packed tables from the host tables ``t``
    (:func:`host_sched_tables`), or None when it cannot take them:

      fire [P, Fp, 2] int32   one word pair per fire row: x = i0 | i1 << 13
                              | op << 26, y = o0 | o1 << 16 (Fp = 32 x the
                              row groups; rows past F: COPY of arc 0 into
                              the sentinel A2)
      bits {G: [P, 32 G]}     for streams of G warps (G = 1, and 2 when Fp
                              >= 64): thread t, bit k if feed row t + 32 G k
                              is fed, 8 + k if drain row t + 32 G k drains,
                              16 + k, 20 + k, 24 + k if some feed, drain or
                              real fire row of rows 32 G k .. 32 G (k + 1) -
                              1 is (the stream skips the group otherwise)"""
    P, F = t["op"].shape
    A2 = t["val0"].shape[0]
    n_in, n_out = t["ia"].shape[0], t["oa"].shape[0]
    g = warp_groups(n_in, F, n_out)
    if g is None or A2 > MAX_WARP_A2:
        return None
    Fp = 32 * g
    pad = lambda x, v: np.pad(x, ((0, 0), (0, Fp - x.shape[1])),
                              constant_values=v)
    op, i0, i1 = pad(t["op"], 0), pad(t["i0"], 0), pad(t["i1"], 0)
    o0, o1 = pad(t["o0"], A2), pad(t["o1"], A2)
    fire = np.stack([i0 | i1 << 13 | op << 26, o0 | o1 << 16], -1)
    feed = pad(t["feed"], 0).astype(np.int64)
    drain = pad(t["drain"], 0).astype(np.int64)
    real = (np.arange(Fp)[None, :] < t["nfire"][:, None]).astype(np.int64)
    bits = {}
    for G in (1, 2):
        TS = 32 * G
        if Fp % TS:
            continue
        word = np.zeros((P, TS), np.int64)
        for k in range(Fp // TS):
            rows = slice(TS * k, TS * (k + 1))
            word |= feed[:, rows] << k | drain[:, rows] << (8 + k)
            for tab, shift in ((feed, 16), (drain, 20), (real, 24)):
                word |= tab[:, rows].any(1, keepdims=True).astype(
                    np.int64) << (shift + k)
        bits[G] = word.astype(np.int32)
    return dict(fire=fire.astype(np.int32), bits=bits, Fp=Fp)


def device_sched_tables(ctx, device) -> SchedTables:
    """The tables of schedule context ``ctx`` on ``device``, cached on the
    context and uploaded again when its registry has grown since (new
    feed lengths register new patterns mid-serving)."""
    dev = torch.device(device)
    key = str(dev)
    tabs = ctx.device_tables.get(key)
    if tabs is None or tabs.n_patterns < len(ctx.registry):
        tabs = upload_sched_tables(host_sched_tables(ctx), dev,
                                   len(ctx.registry))
        ctx.device_tables[key] = tabs
    return tabs


def upload_sched_tables(host: dict, device, n_patterns: int) -> SchedTables:
    """Host tables (:func:`host_sched_tables`), checked, on ``device``
    with the warp variant's packed copies; pids from ``n_patterns`` on
    are stale."""
    ops = check_sched_tables(host)
    tabs = SchedTables({k: torch.tensor(host[k], device=device)
                        for k in TABLE_KEYS})
    tabs.n_patterns = n_patterns
    tabs.ops = ops
    tabs.ops_mask = sum(1 << o for o in ops) | 1 << int(Op.COPY)
    tabs.ptrs = tuple(_vp(tabs[k]) for k in TABLE_KEYS)
    tabs.slot_plans = {}
    warp = warp_tables(host)
    if warp is not None:
        tabs.warp = dict(
            fire=torch.tensor(warp["fire"], device=device),
            bits={G: torch.tensor(b, device=device)
                  for G, b in warp["bits"].items()}, Fp=warp["Fp"])
    return tabs


def flat_program(struct, reps) -> dict:
    """The run kernel's program from :meth:`ConcretePlan.trace_struct
    <repro_torch.core.schedule.ConcretePlan.trace_struct>`: int32 numpy
    ``seg_off``/``seg_len``/``seg_reps`` [S] (segment s runs
    ``pids[seg_off[s]:seg_off[s] + seg_len[s]]`` ``seg_reps[s]`` times)
    and the concatenated ``pids``."""
    lens = [len(pids) for pids, _ in struct]
    it = iter(np.asarray(reps).tolist())
    return dict(
        seg_off=np.asarray(np.cumsum([0] + lens[:-1]) if lens else [],
                           np.int32),
        seg_len=np.asarray(lens, np.int32),
        seg_reps=np.asarray([next(it) if rep else 1 for _, rep in struct],
                            np.int32),
        pids=np.asarray([p for pids, _ in struct for p in pids], np.int32))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the yardstick on the card)
# ---------------------------------------------------------------------------
def _cycle(tab, ops, fv, val, ptr, ol, oc, pid, tok=None):
    """One table-driven scheduled cycle over B rows (every array has a
    leading B axis; ``pid`` is a long tensor [B]).  Feed rows load
    ``fv[r, clip(ptr, 0, L-1)]``, or ``tok`` [B, n_in] where given."""
    B, _, L = fv.shape
    A2 = val.shape[1]
    drop = torch.zeros((B, 1), dtype=val.dtype, device=val.device)
    fm = tab["feed"][pid]                                   # [B, n_in]
    nxt = tok if tok is not None else torch.gather(
        fv, 2, ptr.clamp(0, L - 1).long()[:, :, None])[..., 0]
    tgt = torch.where(fm > 0, tab["ia"].long()[None], A2)
    vx = torch.cat([val, drop], 1).scatter_(1, tgt, nxt)
    ptr = ptr + fm
    a = vx.gather(1, tab["i0"][pid].long())                 # [B, F]
    b = vx.gather(1, tab["i1"][pid].long())
    opv = tab["op"][pid]
    z = a
    for op in ops:
        if Op(op) not in (Op.COPY, Op.SINK):
            z = torch.where(opv == op, _alu_op(op, a, b), z)
    vx = vx.scatter_(1, tab["o0"][pid].long(), z)
    vx = vx.scatter_(1, tab["o1"][pid].long(), z)
    val = vx[:, :A2].contiguous()
    dm = tab["drain"][pid]
    ol = torch.where(dm > 0, val[:, tab["oa"].long()], ol)
    return val, ptr, ol, oc + dm


def sched_run(tables, program, fv):
    """Plain PyTorch scheduled run: B streams ``fv[B, n_in, L]`` from a
    fresh start through the ``program`` (:func:`flat_program`) on
    ``tables`` (:func:`device_sched_tables`).  Returns (out_last,
    out_count), each int32 [B, n_out]."""
    B = fv.shape[0]
    dev = fv.device
    val = tables["val0"][None].repeat(B, 1)
    ptr = torch.zeros((B, tables["ia"].shape[0]), dtype=torch.int32,
                      device=dev)
    ol = torch.zeros((B, tables["oa"].shape[0]), dtype=torch.int32,
                     device=dev)
    oc = torch.zeros_like(ol)
    pid_rows: dict[int, torch.Tensor] = {}
    for off, n, reps in zip(program["seg_off"].tolist(),
                            program["seg_len"].tolist(),
                            program["seg_reps"].tolist()):
        seg = [int(p) for p in program["pids"][off:off + n]]
        for p in seg:
            if p not in pid_rows:
                pid_rows[p] = torch.full((B,), p, dtype=torch.long,
                                         device=dev)
        for _ in range(reps):
            for p in seg:
                val, ptr, ol, oc = _cycle(tables, tables.ops, fv, val, ptr,
                                          ol, oc, pid_rows[p])
    return ol, oc


# stands where the warp variant's shared memory holds no token of the row
_STALE = -1234567


def program_cycles(program) -> int:
    """Cycles a program runs: the sum of its segments' lengths times
    repetitions."""
    return int(np.dot(np.asarray(program["seg_len"], np.int64),
                      np.asarray(program["seg_reps"], np.int64)))


def _program_pids(program):
    """The pids of the program's cycles in order (host numpy)."""
    out = []
    for off, n, reps in zip(program["seg_off"].tolist(),
                            program["seg_len"].tolist(),
                            program["seg_reps"].tolist()):
        out += [int(p) for p in program["pids"][off:off + n]] * reps
    return out


def sched_run_staged(tables, program, fv, *, window: int,
                     misalign: int = 0):
    """The scheduled run in the warp variant's order (plain PyTorch, for
    the tests and ``chip_smoke.py``; the main path runs
    :func:`sched_run`).  Same arguments and results as :func:`sched_run`;
    the results must be equal.  Feed tokens come from windows as the
    kernel stages them: each row's tokens cut into windows of ``window``
    (W, a power of two, at least 4) by position, two buffers a row;
    window 0 is copied and waited for before the first cycle and window
    1 issued; at the start of every chunk of W / 2 cycles the copies
    issued a chunk earlier land and each row in window w whose window
    w + 1 is not yet issued issues it.  A copy is 16-byte pieces aligned
    on the device address (``misalign``: ints between a 16-byte boundary
    and the tokens' start) holding tokens [w W, (w + 1) W) clamped to L -
    1.  Each row's next token is read from its buffer right after the row
    feeds (token 0 after the prologue); a read of a window that has not
    landed, or of a slot the copy did not fill, comes back stale."""
    W = int(window)
    if W < 4 or W & (W - 1):
        raise ValueError(f"window must be a power of two >= 4, got {W}")
    B, n_in, L = fv.shape
    dev = fv.device
    ws, C, last_win = W + 4, W // 2, (L - 1) // W
    stale = lambda *shape: torch.full(shape, _STALE, dtype=fv.dtype,
                                      device=dev)
    flat = torch.cat([stale(misalign), fv.reshape(-1), stale(ws + 8)])
    row = misalign + (torch.arange(B, device=dev)[:, None] * n_in
                      + torch.arange(n_in, device=dev)[None]) * L
    held, pend = stale(B, n_in, 2, ws), stale(B, n_in, 2, ws)
    held_w = torch.full((B, n_in, 2), -1, dtype=torch.long, device=dev)
    pend_w = held_w.clone()
    k = torch.arange(ws, device=dev)

    def issue(w, sel):
        """Copies window w [B, n_in] of the rows where ``sel``."""
        a = w * W
        e = torch.clamp(a + W - 1, max=L - 1)
        start = (row + a) & ~3
        pieces = ((row + e - start) >> 2) + 1
        idx = (start[..., None] + k).clamp(0, flat.numel() - 1)
        vals = torch.where(k < 4 * pieces[..., None], flat[idx],
                           torch.full_like(idx, _STALE, dtype=fv.dtype))
        for par in (0, 1):
            m = sel & ((w & 1) == par)
            pend[:, :, par][m] = vals[m]
            pend_w[:, :, par][m] = w[m]

    def land():
        m = pend_w >= 0
        held[m] = pend[m]
        held_w[m] = pend_w[m]
        pend_w.fill_(-1)

    def read(ptr):
        q = ptr.long().clamp(0, L - 1)
        w = q // W
        slot = (row & 3) + q % W
        buf = torch.gather(held, 2, (w & 1)[..., None, None].expand(
            B, n_in, 1, ws))[:, :, 0]
        v = torch.gather(buf, 2, slot[..., None])[..., 0]
        ok = torch.gather(held_w, 2, (w & 1)[..., None])[..., 0] == w
        return torch.where(ok, v, torch.full_like(v, _STALE))

    val = tables["val0"][None].repeat(B, 1)
    ptr = torch.zeros((B, n_in), dtype=torch.int32, device=dev)
    ol = torch.zeros((B, tables["oa"].shape[0]), dtype=torch.int32,
                     device=dev)
    oc = torch.zeros_like(ol)
    every = torch.ones((B, n_in), dtype=torch.bool, device=dev)
    zero = torch.zeros((B, n_in), dtype=torch.long, device=dev)
    issue(zero, every)
    land()
    tok = read(ptr)
    issued = zero.clone()
    if last_win >= 1:
        issue(zero + 1, every)
        issued += 1
    for c, p in enumerate(_program_pids(program)):
        pid = torch.full((B,), p, dtype=torch.long, device=dev)
        fed = tables["feed"][pid] > 0
        val, ptr, ol, oc = _cycle(tables, tables.ops, fv, val, ptr, ol, oc,
                                  pid, tok=tok)
        tok = torch.where(fed, read(ptr), tok)
        if (c + 1) % C == 0:
            land()
            w = ptr.long().clamp(0, L - 1) // W
            sel = (issued == w) & (w < last_win)
            issue(w + 1, sel)
            issued = torch.where(sel, w + 1, issued)
    return ol, oc


def sched_slot_step(tables, fv, pids, fsel, full, val, ptr, out_last,
                    out_count):
    """Plain PyTorch scheduled slot step: slot b runs the K cycles
    ``pids[b, :]`` (host int32 [B, K]) from its state, then takes
    ``full[b] = t_full[fsel[b]]`` unless ``fsel[b] == -1``.  fv[B, n_in,
    L], full/val[B, A2], ptr[B, n_in], out_last/out_count[B, n_out], all
    int32.  Returns (full', val', ptr', out_last', out_count')."""
    dev = full.device
    pids = torch.as_tensor(np.asarray(pids, np.int32), device=dev).long()
    fsel = torch.as_tensor(np.asarray(fsel, np.int32), device=dev).long()
    ol, oc = out_last, out_count
    for j in range(pids.shape[1]):
        val, ptr, ol, oc = _cycle(tables, tables.ops, fv, val, ptr, ol, oc,
                                  pids[:, j])
    full = torch.where(fsel[:, None] >= 0, tables["full"][fsel.clamp(min=0)],
                       full)
    return full, val, ptr, ol, oc


def slot_window_ints(K: int) -> int:
    """Ints that hold the 16-byte pieces of a feed row's window of at most
    K tokens, wherever the window starts (the replay's buffer; the
    kernel's layout is its launcher's)."""
    return 4 * (((K + 2) >> 2) + 1)


def sched_slot_step_staged(tables, fv, pids, fsel, full, val, ptr, out_last,
                           out_count, *, misalign: int = 0):
    """The scheduled slot step in its warp variant's order (plain
    PyTorch, for the tests and ``chip_smoke.py``; the main path runs
    :func:`sched_slot_step`).  Same arguments and results as
    :func:`sched_slot_step`; the results must be equal.  The order:

    * each slot walks its pid window once: each feed row counts the n
      tokens it takes, and only the cycles that feed, fire or drain run
      (pid 0, the no-op pattern, and any other pattern that does nothing
      are skipped); a slot with no such cycle copies its state through;
    * each feed row's window is copied once: tokens clamp(ptr) ..
      clamp(ptr + n - 1) in 16-byte pieces aligned on the device address
      (``misalign``: ints between a 16-byte boundary and the tokens'
      start), so token p lies at (row + p) - ((row + clamp(ptr)) & ~3); a
      read outside the copied pieces comes back stale;
    * the cycles run in order, each feed taking its token from the
      window at the row's clamped pointer."""
    dev = full.device
    pids = torch.as_tensor(np.asarray(pids, np.int32), device=dev).long()
    fsel = torch.as_tensor(np.asarray(fsel, np.int32), device=dev).long()
    B, n_in, L = fv.shape
    K = pids.shape[1]
    fed = tables["feed"][pids] > 0                          # [B, K, n_in]
    works = fed.any(2) | (tables["drain"][pids] > 0).any(2) \
        | (tables["nfire"][pids] > 0)                       # [B, K]
    nfed = fed.sum(1)                                       # [B, n_in]
    p0 = ptr.long()
    a = p0.clamp(0, L - 1)
    e = (p0 + nfed - 1).clamp(0, L - 1)
    row = misalign + (torch.arange(B, device=dev)[:, None] * n_in
                      + torch.arange(n_in, device=dev)[None]) * L
    start = (row + a) & ~3
    held = torch.where(nfed > 0, 4 * (((row + e - start) >> 2) + 1), 0)
    RI = slot_window_ints(K)
    stale = lambda *shape: torch.full(shape, _STALE, dtype=fv.dtype,
                                      device=dev)
    flat = torch.cat([stale(misalign), fv.reshape(-1), stale(RI + 8)])
    k = torch.arange(RI, device=dev)
    idx = (start[..., None] + k).clamp(0, flat.numel() - 1)
    win = torch.where(k < held[..., None], flat[idx], stale(B, n_in, RI))

    def read(p):
        slot = row + p.long().clamp(0, L - 1) - start
        got = torch.gather(win, 2, slot.clamp(0, RI - 1)[..., None])[..., 0]
        return torch.where((slot >= 0) & (slot < held), got,
                           stale(B, n_in))

    v, pt, ol, oc = val, ptr, out_last, out_count
    for j in range(K):
        run = works[:, j, None]
        nv, npt, nol, noc = _cycle(tables, tables.ops, fv, v, pt, ol, oc,
                                   pids[:, j], tok=read(pt))
        v, pt = torch.where(run, nv, v), torch.where(run, npt, pt)
        ol, oc = torch.where(run, nol, ol), torch.where(run, noc, oc)
    live = works.any(1)[:, None]            # the others copy through
    v, pt = torch.where(live, v, val), torch.where(live, pt, ptr)
    ol, oc = torch.where(live, ol, out_last), torch.where(live, oc, out_count)
    full = torch.where(fsel[:, None] >= 0, tables["full"][fsel.clamp(min=0)],
                       full)
    return full, v, pt, ol, oc


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------
def _host_i32(x, name):
    """Host int32 numpy copy of a program or pid array (numpy or CPU
    tensor); pid windows never come from the device."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name} is host data; got a tensor on "
                             f"{x.device}")
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x), np.int32)


def _check_tables(tables):
    if not isinstance(tables, SchedTables):
        raise TypeError("the kernel takes tables from device_sched_tables() "
                        "only")


def _check_pids(tables, pids, name, lo=0):
    if pids.size and (pids.min() < lo or pids.max() >= tables.n_patterns):
        raise ValueError(
            f"{name}: pid outside [{lo}, {tables.n_patterns}) — the tables "
            "hold fewer patterns than the schedule (stale tables: upload "
            "again with device_sched_tables)")


def _prepare(tables, named, dev):
    """Argument checks common to both wrappers (the tables were checked
    when they were uploaded: here only that they lie on ``dev``);
    returns (A2, n_in, n_out, F, device index)."""
    _check_tensors(named, dev)
    if tables["val0"].device != dev:
        raise ValueError(f"the tables are on {tables['val0'].device}, the "
                         f"state on {dev}")
    A2 = tables["val0"].shape[0]
    n_in, n_out = tables["ia"].shape[0], tables["oa"].shape[0]
    F = tables["op"].shape[1]
    threads = max(n_in, n_out, F)
    if threads > MAX_THREADS:
        raise ValueError(f"{threads} feed, drain or fire rows per pattern; "
                         f"the kernel takes at most {MAX_THREADS}")
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    if 4 * A2 > _smem_limit(index):
        raise ValueError(f"{A2} arc registers need {4 * A2} B of shared "
                         f"memory per CTA; the card gives "
                         f"{_smem_limit(index)}")
    return A2, n_in, n_out, F, index


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.fire_block_error_string(err).decode())


def warp_program(prog) -> dict:
    """The warp variant's program: ``prog`` (host int32, checked) with its
    pids renumbered to the patterns it uses, ``used`` (the global pid of
    each, at least one) and the cycles it runs."""
    used = np.unique(prog["pids"]) if prog["pids"].size else \
        np.zeros(1, np.int32)
    local = np.searchsorted(used, prog["pids"]).astype(np.int32)
    return dict(prog, pids=local, used=used.astype(np.int32),
                cycles=program_cycles(prog))


def warp_plan(tables, program, B, device_index, window=None, warps=None):
    """How the warp variant would run a checked host ``program`` over
    ``tables`` (:func:`device_sched_tables`) and B streams on card
    ``device_index``: dict(window, streams, warps), or None when it
    cannot.  The kernel's launcher plans (``csrc`` ``warp_plan``, which
    owns the shared-memory layout): the longest feed window, then the most
    streams a CTA (up to 4) with which two CTAs fit an SM, or one stream;
    two warps a stream for tables of 64 rows or more while fewer than 4
    streams share each SM, else one.  ``window`` and ``warps`` fix
    those."""
    if tables.warp is None:
        return None
    from repro_torch.kernels import _build
    wp = warp_program(program)
    out = (ctypes.c_int * 3)()
    err = _build.load().sched_warp_plan(
        tables["val0"].shape[0], tables["ia"].shape[0], wp["used"].size,
        tables.warp["Fp"], wp["seg_off"].size, wp["pids"].size, B,
        window or 0, warps or 0, device_index, out)
    return None if err else dict(window=out[0], streams=out[1],
                                 warps=out[2])


def sched_variant(tables, program, B, device_index) -> str:
    """The run kernel's variant for ``tables`` (:func:`device_sched_tables`)
    and a checked host ``program`` over B streams on card
    ``device_index``: ``"warp"`` when the tables are at most
    :data:`WARP_ROWS` rows wide (:attr:`SchedTables.warp` is set) and the
    program's patterns and windows fit the CTA's shared memory
    (:func:`warp_plan`), ``"cta"`` otherwise."""
    if tables.warp is None or warp_plan(tables, program, B,
                                        device_index) is None:
        return "cta"
    return "warp"


def _check_program(tables, program):
    prog = {k: _host_i32(program[k], k) for k in PROGRAM_KEYS}
    S, M = prog["seg_off"].size, prog["pids"].size
    if not prog["seg_len"].size == prog["seg_reps"].size == S:
        raise ValueError("seg_off, seg_len and seg_reps differ in length")
    if S and (prog["seg_len"].min() < 0 or prog["seg_reps"].min() < 0
              or prog["seg_off"].min() < 0
              or (prog["seg_off"] + prog["seg_len"]).max() > M):
        raise ValueError("a program segment lies outside its pid list")
    _check_pids(tables, prog["pids"], "program")
    if program_cycles(prog) >= 1 << 31:
        raise ValueError("the program runs 2^31 cycles or more")
    return prog


def _launch_run(variant, tables, prog, fv, window=None, warps=None,
                restage=True):
    """Check the arguments and launch the run kernel's ``variant``; feed
    windows of ``window`` tokens and ``warps`` warps a stream (warp
    variant; default the launcher's plan, :func:`warp_plan`);
    ``restage=False`` is the latency floor.  Records the launch's plan in
    ``sched_run_cuda.last_plan``.  Returns (out_last, out_count)."""
    from repro_torch.kernels import _build
    if variant not in SCHED_VARIANTS or (variant == "warp"
                                         and tables.warp is None):
        raise ValueError(f"variant {variant!r} cannot run these tables")
    dev = fv.device
    A2, n_in, n_out, F, index = _prepare(tables, (("fv", fv),), dev)
    if fv.dim() != 3 or fv.shape[1] != n_in or fv.shape[0] < 1 \
            or fv.shape[2] < 1:
        raise ValueError(f"fv: shape {tuple(fv.shape)}, want (B >= 1, "
                         f"{n_in}, L >= 1)")
    B, L = fv.shape[0], fv.shape[2]
    lib = _build.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    plan = dict(variant=variant, window=None, streams=1, warps=None)
    with torch.cuda.device(index):
        ol = torch.empty((B, n_out), dtype=torch.int32, device=dev)
        oc = torch.empty_like(ol)
        if variant == "cta":
            flat = torch.as_tensor(np.concatenate(
                [prog[k] for k in PROGRAM_KEYS] + [np.zeros(1, np.int32)]),
                device=dev)
            err = lib.sched_run_launch(
                *tables.ptrs, _vp(flat), _vp(fv), _vp(ol), _vp(oc),
                prog["seg_off"].size, B, A2, n_in, n_out, L, F, stream)
        else:
            run = warp_plan(tables, prog, B, index, window, warps)
            if run is None:
                raise ValueError(
                    f"the warp variant cannot run this program (window "
                    f"{window or 'planned'}, {warps or 'planned'} warps a "
                    "stream): shapes or shared memory")
            plan.update(run)
            wp = warp_program(prog)
            flat = torch.as_tensor(np.concatenate(
                [wp[k] for k in (*PROGRAM_KEYS, "used")]), device=dev)
            ptr = fv.data_ptr()
            err = lib.sched_run_warp_launch(
                _vp(tables.warp["fire"]), _vp(tables.warp["bits"][run["warps"]]),
                _vp(tables["ia"]), _vp(tables["oa"]), _vp(tables["val0"]),
                _vp(flat), ctypes.c_void_p(ptr & ~15), _vp(ol), _vp(oc),
                (ptr & 15) // 4, wp["seg_off"].size, wp["pids"].size,
                wp["used"].size, B, A2, n_in, n_out, L, tables.warp["Fp"],
                wp["cycles"], run["window"], run["warps"], int(restage),
                tables.ops_mask, stream)
    _raise_on(err, lib, f"sched_run ({variant} variant)")
    sched_run_cuda.last_plan = plan
    return ol, oc


def sched_run_cuda(tables, program, fv):
    """A whole scheduled run in one launch (the counterpart of
    ``make_sched_run``, solo and batched) over the streams of ``fv[B,
    n_in, L]``: the variant :func:`sched_variant` picks (one warp per
    stream, or one CTA).  CUDA tensors launch the kernel and count it in
    ``sched_run_cuda.launches`` and ``launches_by``; CPU tensors take
    :func:`sched_run`.  Returns (out_last, out_count) [B, n_out]."""
    _check_tables(tables)
    prog = _check_program(tables, program)
    if _on_cpu(fv, tables["val0"]):
        return sched_run(tables, prog, fv)
    dev = fv.device
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    variant = sched_variant(tables, prog, fv.shape[0] if fv.dim() else 1,
                            index)
    out = _launch_run(variant, tables, prog, fv)
    sched_run_cuda.launches += 1
    sched_run_cuda.launches_by[variant] += 1
    return out


def launch_sched_variant(variant, tables, program, fv, window=None,
                         warps=None):
    """One launch of the run kernel's ``variant`` (``"warp"`` only for
    tables that take it) with feed windows of ``window`` tokens and
    ``warps`` warps a stream, on CUDA tensors, counted nowhere: the tests
    and ``chip_smoke.py`` hold each variant against the plain versions
    and the other variant with it.  Arguments and results as
    :func:`sched_run_cuda`."""
    _check_tables(tables)
    return _launch_run(variant, tables, _check_program(tables, program),
                       fv, window, warps)


def sched_floor_cuda(tables, program, fv):
    """The warp variant's latency floor, for timing: its own loop over the
    program — the next cycle's pid and entries read from shared memory,
    the cursor's advance, each feed's token read from its window, the bit
    tests, the fire and the drain — on one stream of one warp (``fv[:1]``,
    CUDA), with the feed windows staged once and never again (no copy from
    device memory inside the loop), counted nowhere.  The results are not
    the run's."""
    _check_tables(tables)
    return _launch_run("warp", tables, _check_program(tables, program),
                       fv[:1], warps=1, restage=False)


def slot_plan(tables, K, B, device_index):
    """How the slot step's warp variant would run K cycles of B slots
    over ``tables`` (:func:`device_sched_tables`) on card
    ``device_index``: dict(streams), or None when it cannot.  The
    kernel's launcher plans (``csrc`` ``slot_plan``, which owns the
    shared-memory layout): one warp a slot, the most slots a CTA (up to
    4) with which two CTAs fit an SM, or one slot; None when one slot's
    windows for K cycles do not fit a CTA."""
    if tables.warp is None:
        return None
    key = (K, B, device_index)
    if key not in tables.slot_plans:
        from repro_torch.kernels import _build
        out = (ctypes.c_int * 1)()
        err = _build.load().sched_slot_plan(
            tables["val0"].shape[0], tables["ia"].shape[0],
            tables["oa"].shape[0], tables.warp["Fp"], K, B, device_index,
            out)
        tables.slot_plans[key] = None if err else dict(streams=out[0])
    plan = tables.slot_plans[key]
    return None if plan is None else dict(plan)


def slot_variant(tables, K, B, device_index) -> str:
    """The slot kernel's variant for ``tables`` (:func:`device_sched_tables`)
    and K cycles of B slots on card ``device_index``: ``"warp"`` when the
    tables are at most :data:`WARP_ROWS` rows wide (:attr:`SchedTables.warp`
    is set) and one slot's feed windows for K cycles fit a CTA
    (:func:`slot_plan`), ``"cta"`` otherwise."""
    if slot_plan(tables, K, B, device_index) is None:
        return "cta"
    return "warp"


def _check_slot(tables, fv, pids, fsel, state):
    """Argument checks of a slot-step launch on the card; returns (B, K,
    L, A2, n_in, n_out, F, device index)."""
    full = state[0]
    dev = full.device
    names = ("fv", "full", "val", "ptr", "out_last", "out_count")
    A2, n_in, n_out, F, index = _prepare(tables, zip(names, (fv, *state)),
                                         dev)
    B = full.shape[0]
    L = fv.shape[-1]
    want = dict(fv=(B, n_in, L), full=(B, A2), val=(B, A2), ptr=(B, n_in),
                out_last=(B, n_out), out_count=(B, n_out))
    for k, x in zip(names, (fv, *state)):
        if tuple(x.shape) != want[k]:
            raise ValueError(f"{k}: shape {tuple(x.shape)}, want {want[k]}")
    if pids.ndim != 2 or pids.shape[0] != B or fsel.shape != (B,):
        raise ValueError(f"pids {pids.shape} / fsel {fsel.shape}: want "
                         f"({B}, K) / ({B},)")
    if B < 1 or L < 1:
        raise ValueError("the kernel needs B >= 1 and L >= 1")
    return B, pids.shape[1], L, A2, n_in, n_out, F, index


def _launch_slot(variant, tables, fv, pids, fsel, state):
    """Check the arguments (host pids and fsel already checked) and launch
    the slot kernel's ``variant`` (the warp one as the launcher plans it,
    :func:`slot_plan`).  Records the launch's plan in
    ``sched_slot_step_cuda.last_plan``.  Returns (full', val', ptr',
    out_last', out_count')."""
    from repro_torch.kernels import _build
    if variant not in SLOT_VARIANTS or (variant == "warp"
                                        and tables.warp is None):
        raise ValueError(f"variant {variant!r} cannot run these tables")
    B, K, L, A2, n_in, n_out, F, index = _check_slot(tables, fv, pids, fsel,
                                                     state)
    dev = fv.device
    plan = dict(variant=variant, streams=1)
    if variant == "warp":
        run = slot_plan(tables, K, B, index)
        if run is None:
            raise ValueError(
                f"the warp variant cannot run K = {K} cycles of {B} slots: "
                "shapes or shared memory")
        plan.update(run)
    lib = _build.load()
    _, on_device, stream = _device_and_stream(dev)
    with on_device:
        ctl = torch.as_tensor(np.concatenate([pids.reshape(-1), fsel]),
                              device=dev)
        fsel_p = ctypes.c_void_p(ctl.data_ptr() + 4 * B * K)
        outs = [torch.empty_like(x) for x in state]
        io = (*(_vp(x) for x in state), *(_vp(x) for x in outs))
        if variant == "cta":
            err = lib.sched_slot_step_launch(
                *tables.ptrs, _vp(fv), _vp(ctl), fsel_p, *io, B, K, A2, n_in,
                n_out, L, F, stream)
        else:
            ptr = fv.data_ptr()
            err = lib.sched_slot_warp_launch(
                _vp(tables.warp["fire"]),
                _vp(tables.warp["bits"][1]), _vp(tables["ia"]),
                _vp(tables["oa"]), _vp(tables["full"]),
                ctypes.c_void_p(ptr & ~15), _vp(ctl), fsel_p, *io,
                (ptr & 15) // 4, B, K, A2, n_in, n_out, L,
                tables.warp["Fp"], tables.ops_mask, stream)
    _raise_on(err, lib, f"sched_slot_step ({variant} variant)")
    sched_slot_step_cuda.last_plan = plan
    return tuple(outs)


def _slot_args(tables, pids, fsel):
    _check_tables(tables)
    pids = _host_i32(pids, "pids")
    fsel = _host_i32(fsel, "fsel")
    _check_pids(tables, pids, "pids")
    _check_pids(tables, fsel, "fsel", lo=-1)
    return pids, fsel


def sched_slot_step_cuda(tables, fv, pids, fsel, full, val, ptr, out_last,
                         out_count):
    """K scheduled cycles per slot (the counterpart of
    ``make_sched_slot_step``): ``pids`` (host int32 [B, K]) and ``fsel``
    (host int32 [B]) from the plan.  CUDA tensors launch the variant
    :func:`slot_variant` picks (one warp per slot, or one CTA) and count it
    in ``sched_slot_step_cuda.launches`` and ``launches_by``; CPU tensors
    take :func:`sched_slot_step`.  Returns (full', val', ptr', out_last',
    out_count')."""
    pids, fsel = _slot_args(tables, pids, fsel)
    state = (full, val, ptr, out_last, out_count)
    if _on_cpu(fv, *state, tables["val0"]):
        return sched_slot_step(tables, fv, pids, fsel, *state)
    dev = full.device
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    K = pids.shape[1] if pids.ndim == 2 else 0
    variant = slot_variant(tables, K, full.shape[0] if full.dim() else 1,
                           index)
    out = _launch_slot(variant, tables, fv, pids, fsel, state)
    sched_slot_step_cuda.launches += 1
    sched_slot_step_cuda.launches_by[variant] += 1
    return out


def launch_slot_variant(variant, tables, fv, pids, fsel, full, val, ptr,
                        out_last, out_count):
    """One launch of the slot kernel's ``variant`` (``"warp"`` only for
    tables and K that take it) on CUDA tensors, counted nowhere: the tests
    and ``chip_smoke.py`` hold each variant against the plain versions and
    the other variant with it.  Arguments and results as
    :func:`sched_slot_step_cuda`."""
    pids, fsel = _slot_args(tables, pids, fsel)
    return _launch_slot(variant, tables, fv, pids, fsel,
                        (full, val, ptr, out_last, out_count))


def sched_slot_floor_cuda(tables, fv, pids, fsel, full, val, ptr, out_last,
                          out_count):
    """The slot step's latency floor, for timing: the warp variant's own
    launch — its pid walk, its windows staged once, its loop over the
    cycles that work — on one slot (slot 0 of the arguments, CUDA) of one
    warp, counted nowhere.  Returns slot 0's results."""
    pids, fsel = _slot_args(tables, pids, fsel)
    return _launch_slot("warp", tables, fv[:1], pids[:1], fsel[:1],
                        (full[:1], val[:1], ptr[:1], out_last[:1],
                         out_count[:1]))


sched_run_cuda.launches = 0
sched_run_cuda.launches_by = dict.fromkeys(SCHED_VARIANTS, 0)
sched_run_cuda.last_plan = None
sched_slot_step_cuda.launches = 0
sched_slot_step_cuda.launches_by = dict.fromkeys(SLOT_VARIANTS, 0)
sched_slot_step_cuda.last_plan = None
