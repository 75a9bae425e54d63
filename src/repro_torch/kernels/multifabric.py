"""The sharded block: K lockstep cycles of a fabric partitioned into P
regions (DESIGN.md §14), for B streams at once.

The JAX package computes it in ``MultiFabric._core_fn``
(``repro/core/multifabric.py:285``), a jnp program: the regions under
``vmap`` or ``shard_map`` and one ``lax.psum`` a cycle that merges the
token channels of the cut arcs.  No Pallas kernel is involved.  Here:

* :func:`mf_block` — the plain PyTorch version: the regions as one flat
  register file per stream (region r owns slots ``r * A2m ..`` and node
  rows ``r * N2m ..``; a cut arc has an out-copy slot in its producer's
  region and an in-copy slot in its consumer's, and one channel register),
  every region's nodes evaluated together.  The psum of the channel merge
  becomes a gather from the out-copy: exactly one region contributes to
  each channel's sum, so the gather is the sum, and a float token (-0.0
  and NaN payloads included) passes bit for bit.  Any token dtype of the
  ``"torch"`` backend (int32, uint32 in its int64 carrier, float32): it is
  that backend's block program and, on int32, the kernel's plain version;
* :func:`mf_block_cuda` — the wrapper: on CUDA tensors it launches the
  hand-written kernel of ``csrc/multifabric.cu`` (built at first use by
  :mod:`repro_torch.kernels._build`) in the variant :func:`mf_variant`
  picks from the table sizes — ``"warp"`` (a stream's every region in one
  warp's lanes, 4 streams a CTA) or ``"cta"`` (one CTA per stream, one
  warp per region) — and counts the launch; on CPU tensors it computes
  :func:`mf_block`.  :func:`launch_mf` launches either variant uncounted
  (tests, ``chip_smoke.py``).

Both update the state in place and return (fired[B], last_prog[B]).
The tables come from :class:`repro_torch.core.multifabric.MultiFabric`
(``MultiFabric.tables``, numpy) through :func:`device_tables`:

  opcode[PN], in_idx[PN, 3], out_idx[PN, 2]     node rows (flat slots)
  prod_node/prod_slot, cons_node/cons_slot[PA]  arc adjacency (flat rows;
                                                a region's dummy row where
                                                an arc has none)
  const_mask[PA], occ_mask[PA]                  const buses; slots the
                                                occupancy counters sample
  in_slot[n_in], out_slot[n_out]                the graph's feed and drain
                                                rows' slots
  ch_in[C], ch_out[C]                           each channel's two copies

(PN = P * N2m, PA = P * A2m.)  State: fv[B, n_in, L], fl[B, n_in] (read
only), full[B, PA] int32, val[B, PA], ptr[B, n_in], out_last[B, n_out],
out_count[B, n_out], chf/chv[B, Cp] (Cp = max(C, 1)); counters nf, si, so
[B, PN], ab, ahw [B, PA] and the channels' busy, high water and pushes
[B, Cp].
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.engine import _alu_op, _node_inputs_ready
from repro_torch.core.graph import Op
from repro_torch.kernels.dataflow_fire import (STAGE_CYCLES, _check_tensors,
                                               _on_cpu, _smem_limit, _vp,
                                               window_ints)

TABLE_KEYS = ("opcode", "in_idx", "out_idx", "prod_node", "prod_slot",
              "cons_node", "cons_slot", "const_mask", "occ_mask", "in_slot",
              "out_slot", "ch_in", "ch_out")
VARIANTS = ("warp", "cta")
# the kernel's limits (csrc kMaxRegions, 32 * kMaxRows, kMaxStreams): the
# warp variant takes P N2m and P A2m up to WARP_ROWS, the CTA variant up
# to MAX_REGIONS regions of REGION_ROWS node rows and arc slots
MAX_REGIONS = 32
REGION_ROWS = WARP_ROWS = 32 * 8
MAX_STREAMS = 4
# an arc slot's flag word (csrc kConst ... kDrained); bits 16-31 hold its
# feed row, output row or channel
K_CONST, K_OCC, K_CH_IN, K_CH_OUT, K_FED, K_DRAINED = (1 << k for k in
                                                       range(5, 11))
_VALUE_OPS = tuple(op for op in Op if op not in (
    Op.COPY, Op.BRANCH, Op.SINK, Op.NDMERGE, Op.DMERGE))


class MfTables(dict):
    """Device copies of the :data:`TABLE_KEYS` tables, with ``P``,
    ``N2m``, ``A2m`` and ``C`` as attributes, ``present`` (the value
    opcodes some node has: the ALU selects among them), ``ops`` (bit k
    set when some node row has opcode k), ``variant`` (the kernel's,
    :func:`mf_variant`) and ``words`` (the kernel's packed tables,
    :func:`kernel_words`; None for tables past the kernel's limits, named
    by ``too_large``)."""
    P = N2m = A2m = C = 0
    present = ()
    ops = 0
    variant = None
    words = None
    too_large = None
    index_tables = None     # the plain version's int64 / bool copies


def mf_variant(P: int, N2m: int, A2m: int) -> str | None:
    """The kernel's variant for P regions of N2m node rows and A2m arc
    slots: ``"warp"`` when the flat tables (P N2m rows, P A2m slots) fit
    one warp's :data:`WARP_ROWS`, ``"cta"`` for up to :data:`MAX_REGIONS`
    regions of :data:`REGION_ROWS` each, else None (no kernel)."""
    if P * max(N2m, A2m) <= WARP_ROWS:
        return "warp"
    if P <= MAX_REGIONS and max(N2m, A2m) <= REGION_ROWS:
        return "cta"
    return None


def kernel_words(t) -> dict:
    """The kernel's packed tables from numpy tables: one row of 3 words a
    node (``in0 | in1 << 16``, ``in2 | out0 << 16``, ``out1 | opcode <<
    16``) and of 2 words an arc slot (``prod_node | cons_node << 16``, the
    flag word: ``8 << prod_slot | 1 << cons_slot``, :data:`K_CONST` ...,
    and the slot's feed row, output row or channel in bits 16-31).  Both
    copies of a channel name the channel's real producer (the out-copy's)
    and real consumer (the in-copy's), so the kernel updates each copy as
    an uncut arc: that is the merge."""
    i, o = t["in_idx"].astype(np.int64), t["out_idx"].astype(np.int64)
    node = np.stack([i[:, 0] | i[:, 1] << 16, i[:, 2] | o[:, 0] << 16,
                     o[:, 1] | t["opcode"].astype(np.int64) << 16], 1)
    prod_node = t["prod_node"].astype(np.int64)
    prod_slot = t["prod_slot"].astype(np.int64)
    cons_node = t["cons_node"].astype(np.int64)
    cons_slot = t["cons_slot"].astype(np.int64)
    ch_in, ch_out = t["ch_in"], t["ch_out"]
    for copies in (ch_in, ch_out):
        prod_node[copies] = t["prod_node"][ch_out]
        prod_slot[copies] = t["prod_slot"][ch_out]
        cons_node[copies] = t["cons_node"][ch_in]
        cons_slot[copies] = t["cons_slot"][ch_in]
    flag = (8 << prod_slot) | (1 << cons_slot)
    flag |= np.where(t["const_mask"] > 0, K_CONST, 0)
    flag |= np.where(t["occ_mask"] > 0, K_OCC, 0)
    aux = np.zeros_like(flag)
    # the real rows only: a pad feed row (fl 0) or drain row points at an
    # EMPTY_PAD slot that nothing fills, and no lane need own it
    for slots, bit in ((t["in_slot"][:t["feed_rows"]], K_FED),
                       (t["out_slot"][:t["drain_rows"]], K_DRAINED),
                       (t["ch_in"], K_CH_IN), (t["ch_out"], K_CH_OUT)):
        for k, s in enumerate(slots):
            if flag[s] & (K_FED | K_DRAINED | K_CH_IN | K_CH_OUT):
                raise ValueError(f"arc slot {s} has two roles")
            flag[s] |= bit
            aux[s] = k
    arc = np.stack([prod_node | cons_node << 16, flag | aux << 16], 1)
    # int32 bit patterns
    return dict(node=node.astype(np.uint32).view(np.int32),
                arc=arc.astype(np.uint32).view(np.int32))


def device_tables(tables, device) -> MfTables:
    """int32 tensors on ``device`` from ``MultiFabric.tables`` (numpy),
    after checking every index against the table sizes, with the
    kernel's variant and packed words when the tables are within its
    limits (:func:`mf_variant`)."""
    P, N2m, A2m = (int(tables[k]) for k in ("P", "N2m", "A2m"))
    PN, PA = P * N2m, P * A2m
    t = {k: np.asarray(tables[k], np.int32) for k in TABLE_KEYS}
    C = t["ch_in"].shape[0]
    shapes = dict(opcode=(PN,), in_idx=(PN, 3), out_idx=(PN, 2),
                  in_slot=t["in_slot"].shape, out_slot=t["out_slot"].shape,
                  ch_in=(C,), ch_out=(C,))
    bounds = dict(in_idx=PA, out_idx=PA, prod_node=PN, prod_slot=2,
                  cons_node=PN, cons_slot=3, in_slot=PA, out_slot=PA,
                  ch_in=PA, ch_out=PA, opcode=len(Op))
    for k, x in t.items():
        if x.shape != shapes.get(k, (PA,)):
            raise ValueError(f"table {k}: shape {x.shape}, want "
                             f"{shapes.get(k, (PA,))}")
        if k in bounds and x.size and (x.min() < 0 or x.max() >= bounds[k]):
            raise ValueError(f"table {k}: index outside [0, {bounds[k]})")
    out = MfTables({k: torch.tensor(x, device=device) for k, x in t.items()})
    out.P, out.N2m, out.A2m, out.C = P, N2m, A2m, C
    present = {int(o) for o in t["opcode"]}
    out.present = tuple(op for op in _VALUE_OPS if int(op) in present)
    out.ops = int(np.bitwise_or.reduce(1 << t["opcode"].astype(np.int64)))
    out.variant = mf_variant(P, N2m, A2m)
    if out.variant is None and P > MAX_REGIONS:
        out.too_large = f"{P} regions (the kernel takes {MAX_REGIONS})"
    elif out.variant is None:
        out.too_large = (f"a region of {N2m} node rows and {A2m} arc slots "
                         f"(the kernel takes {REGION_ROWS} of each)")
    else:
        out.words = {k: torch.tensor(x, device=device) for k, x in
                     kernel_words({**t, "feed_rows": tables["feed_rows"],
                                   "drain_rows": tables["drain_rows"]}
                                  ).items()}
    return out


def _index_tables(tabs) -> dict:
    """The index tables as int64 tensors (and the masks as bool), made
    once per ``tabs``."""
    if tabs.index_tables is None:
        lt = {k: tabs[k].long() for k in TABLE_KEYS}
        for k in ("const_mask", "occ_mask"):
            lt[k] = tabs[k] > 0
        op = tabs["opcode"]
        lt["is"] = {o: op == int(o) for o in (Op.NDMERGE, Op.DMERGE,
                                              Op.BRANCH)}
        tabs.index_tables = lt
    return tabs.index_tables


def _fire_rule(t, present, f, v, dtype):
    """The generic fire rule on registers ``f`` (bool) / ``v`` [B, PA]:
    ready [B, PN], z [B, PN], consume [B, PN, 3], produce [B, PN, 2] — the
    rule of ``MultiFabric._core_fn``'s ``fire``, the ALU selecting among
    the value opcodes ``present``."""
    in_idx, opcode = t["in_idx"], t["opcode"]
    inf = f[:, in_idx]
    oute = ~f[:, t["out_idx"]]
    a, b = v[:, in_idx[:, 0]], v[:, in_idx[:, 1]]
    ctrl3, ctrl2 = v[:, in_idx[:, 2]] != 0, b != 0
    in0, in1, in2 = inf.unbind(-1)
    oe0, oe1 = oute.unbind(-1)
    all_out = oute.all(-1)
    is_nd, is_dm, is_br = (t["is"][o] for o in (Op.NDMERGE, Op.DMERGE,
                                                 Op.BRANCH))
    ready = inf.all(-1) & all_out
    ready = torch.where(is_nd, (in0 | in1) & all_out, ready)
    ready = torch.where(is_dm, in2 & torch.where(ctrl3, in0, in1) & all_out,
                        ready)
    ready = torch.where(is_br, in0 & in1 & torch.where(ctrl2, oe0, oe1),
                        ready)
    z = a
    for op in present:
        z = torch.where(opcode == int(op), _alu_op(op, a, b, dtype), z)
    z = torch.where(is_nd, torch.where(in0, a, b), z)
    z = torch.where(is_dm, torch.where(ctrl3, a, b), z)
    r = ready[..., None]
    consume = r.expand(*ready.shape, 3)
    consume = torch.where(is_nd[:, None], r & torch.stack(
        [in0, ~in0, torch.zeros_like(in0)], -1), consume)
    consume = torch.where(is_dm[:, None], r & torch.stack(
        [ctrl3, ~ctrl3, torch.ones_like(ctrl3)], -1), consume)
    produce = r.expand(*ready.shape, 2)
    produce = torch.where(is_br[:, None], r & torch.stack([ctrl2, ~ctrl2], -1),
                          produce)
    return ready, z, consume, produce


def mf_block(tabs, fv, fl, full, val, ptr, out_last, out_count, chf, chv, *,
             n_cycles: int, active=None, prof=None, chprof=None,
             dtype=np.int32):
    """Plain PyTorch sharded block: ``n_cycles`` lockstep cycles of B
    streams, as ``MultiFabric._core_fn`` computes them, updating the state
    in place.  ``val``, ``fv`` and ``out_last`` hold tokens of ``dtype``
    in its carrier (int32, int64 for uint32, float32); every other array
    is int32.  ``active`` (int32[B], default all ones) is the clock gate: a
    parked stream keeps its state and counters and reports 0.  ``prof``:
    the five node and arc counters, ``chprof``: the three channel
    counters (both or neither).  Returns (fired[B], last_prog[B]) int32.
    The channel slots of ``full``/``val`` leave holding the channel
    registers (the mirror that starts every cycle, done once more)."""
    if (prof is None) != (chprof is None):
        raise ValueError("prof and chprof go together")
    t = _index_tables(tabs)
    present = tabs.present
    B, L = full.shape[0], fv.shape[2]
    C = tabs.C
    ch_in, ch_out, ia, oa = t["ch_in"], t["ch_out"], t["in_slot"], \
        t["out_slot"]
    f, v = full > 0, val.clone()
    p, ol, oc = ptr.clone(), out_last.clone(), out_count.clone()
    cf, cv = chf[:, :C] > 0, chv[:, :C].clone()
    cnt = [x.clone() for x in prof] if prof is not None else None
    chc = [x[:, :C].clone() for x in chprof] if prof is not None else None
    zero = torch.zeros((B,), dtype=torch.int32, device=full.device)
    fired, lp = zero, zero
    for cyc in range(n_cycles):
        # 1. mirror the channel registers into both copies
        for sl in (ch_in, ch_out):
            f[:, sl] = cf
            v[:, sl] = cv
        # 2. feed the environment's input arcs
        can = ~f[:, ia] & (p < fl)
        nxt = fv.gather(2, p.clamp(0, L - 1).long()[:, :, None])[:, :, 0]
        v[:, ia] = torch.where(can, nxt, v[:, ia])
        f[:, ia] = f[:, ia] | can
        p = p + can.to(p.dtype)
        # 3. fire every ready node on the post-feed registers
        if cnt is not None:
            ir = _node_inputs_ready(t["opcode"], t["in_idx"], f, v)
        ready, z, consume, produce = _fire_rule(t, present, f, v, dtype)
        produced = produce[:, t["prod_node"], t["prod_slot"]]
        consumed = consume[:, t["cons_node"], t["cons_slot"]]
        f = (f & ~consumed) | produced | t["const_mask"]
        v = torch.where(produced, z[:, t["prod_node"]], v)
        # 4. channel deltas: the producer region's push, the consumer
        #    region's consume
        push = ~cf & f[:, ch_out]
        consd = cf & ~f[:, ch_in]
        pv = v[:, ch_out]
        if cnt is not None:
            occ = (f & t["occ_mask"]).to(torch.int32)
            nf, si, so, ab, ahw = cnt
            cnt = [nf + ready.to(torch.int32), si + (~ir).to(torch.int32),
                   so + (ir & ~ready).to(torch.int32), ab + occ,
                   torch.maximum(ahw, occ)]
        # 5. drain the output arcs
        got = f[:, oa]
        ol = torch.where(got, v[:, oa], ol)
        oc = oc + got.to(oc.dtype)
        f[:, oa] = False
        # 6. merge: full' = (full & ~consumed) | pushed
        cf = (cf & ~consd) | push
        cv = torch.where(push, pv, cv)
        if chc is not None:
            c32 = cf.to(torch.int32)
            chc = [chc[0] + c32, torch.maximum(chc[1], c32),
                   chc[2] + push.to(torch.int32)]
        n = ready.sum(1, dtype=torch.int32)
        prog = can.any(1) | got.any(1) | (n > 0)
        fired = fired + n
        lp = torch.where(prog, zero + (cyc + 1), lp)
    for sl in (ch_in, ch_out):
        f[:, sl] = cf
        v[:, sl] = cv
    keep = None if active is None else (active != 0)

    def put(dst, new):
        if keep is not None:
            new = torch.where(keep.reshape(-1, *([1] * (new.dim() - 1))),
                              new, dst)
        dst.copy_(new)
    for dst, new in ((full, f.to(full.dtype)), (val, v), (ptr, p),
                     (out_last, ol), (out_count, oc), (chf[:, :C], cf.to(
                         chf.dtype)), (chv[:, :C], cv)):
        put(dst, new)
    if prof is not None:
        for dst, new in zip((*prof, *(x[:, :C] for x in chprof)),
                            (*cnt, *chc)):
            put(dst, new)
    if keep is not None:
        fired = torch.where(keep, fired, zero)
        lp = torch.where(keep, lp, zero)
    return fired, lp


def _check(tabs, fv, fl, state, active, prof, chprof):
    """Every tensor on the state's card, int32, contiguous and of its
    shape."""
    B, n_in, L = fv.shape
    PA, PN = tabs.P * tabs.A2m, tabs.P * tabs.N2m
    n_out, Cp = state[3].shape[1], state[5].shape[1]
    want = dict(fv=(B, n_in, L), fl=(B, n_in), full=(B, PA), val=(B, PA),
                ptr=(B, n_in), out_last=(B, n_out), out_count=(B, n_out),
                chf=(B, Cp), chv=(B, Cp))
    args = dict(zip(want, (fv, fl, *state)))
    if active is not None:
        want["active"], args["active"] = (B,), active
    if (prof is None) != (chprof is None):
        raise ValueError("prof and chprof go together")
    if prof is not None:
        if len(prof) != 5 or len(chprof) != 3:
            raise ValueError("prof holds 5 arrays and chprof 3")
        for k, x, n in zip(("nf", "si", "so", "ab", "ahw", "cb", "chw",
                            "cpu"), (*prof, *chprof),
                           (PN, PN, PN, PA, PA, Cp, Cp, Cp)):
            want[k], args[k] = (B, n), x
    if n_in != tabs["in_slot"].shape[0] or n_out != tabs["out_slot"].shape[0] \
            or Cp != max(tabs.C, 1):
        raise ValueError("the state does not belong to these tables")
    _check_tensors((*args.items(), *tabs.words.items()), state[0].device)
    for k, x in args.items():
        if tuple(x.shape) != want[k]:
            raise ValueError(f"{k}: shape {tuple(x.shape)}, want {want[k]}")
    if B < 1 or L < 1:
        raise ValueError("the kernel needs B >= 1 and L >= 1")


def mf_plan(variant, P, N2m, A2m, n_in, B, n_cycles, smem_bytes,
            smem_limit):
    """How a launch runs: (chunk, window ints per staged row, streams per
    CTA).  The chunk is :data:`STAGE_CYCLES` cycles (at most the block's),
    halved until a stream's shared memory fits the card's ``smem_limit``;
    the warp variant packs up to :data:`MAX_STREAMS` streams into a CTA
    while two such CTAs fit an SM (``dataflow_fire.launch_plan``'s rule).
    ``smem_bytes`` is the library's ``mf_block_smem_bytes``."""
    code = VARIANTS.index(variant)
    chunk = max(1, min(STAGE_CYCLES, n_cycles))
    while True:
        window = window_ints(chunk)
        per = smem_bytes(P, N2m, A2m, n_in, code, window)
        if per <= smem_limit or chunk == 1:
            break
        chunk = (chunk + 1) // 2
    if per > smem_limit:
        raise ValueError(f"the sharded block needs {per} B of shared memory "
                         f"per stream; the card gives {smem_limit}")
    streams = 1
    if variant == "warp":
        streams = max(1, min(MAX_STREAMS, B, smem_limit // 2 // per))
    return chunk, window, streams


def launch_mf(tabs, fv, fl, full, val, ptr, out_last, out_count, chf, chv,
              *, n_cycles: int, active=None, prof=None, chprof=None,
              variant=None, chunk=None):
    """One launch of the sharded block kernel on CUDA tensors, counted
    nowhere (the tests and ``chip_smoke.py`` hold each variant against
    :func:`mf_block` with it): ``variant`` (default the tables' own;
    ``"warp"`` only for tables that take it) with feed windows staged
    every ``chunk`` cycles (default :func:`mf_plan`'s).  Arguments and
    results as :func:`mf_block_cuda`; a failed build or launch raises, and
    tables past the kernel's limits raise ``ValueError`` naming the
    limit."""
    from repro_torch.kernels import _build
    if not isinstance(tabs, MfTables):
        raise TypeError("the kernel takes tables from device_tables() only")
    if tabs.words is None:
        raise ValueError("the sharded block kernel cannot run "
                         f"{tabs.too_large}")
    variant = tabs.variant if variant is None else variant
    if variant not in VARIANTS or (variant == "warp"
                                   and tabs.variant != "warp"):
        raise ValueError(f"variant {variant!r} cannot run these tables "
                         f"(they take {tabs.variant!r})")
    if n_cycles < 0:
        raise ValueError(f"n_cycles must be >= 0, got {n_cycles}")
    state = (full, val, ptr, out_last, out_count, chf, chv)
    _check(tabs, fv, fl, state, active, prof, chprof)
    dev = full.device
    B, n_in, L = fv.shape
    lib = _build.load()
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    plan_chunk, window, streams = mf_plan(
        variant, tabs.P, tabs.N2m, tabs.A2m, n_in, B, n_cycles,
        lib.mf_block_smem_bytes, _smem_limit(index))
    if chunk is not None:
        if not 1 <= chunk <= plan_chunk:
            raise ValueError(f"chunk must be in [1, {plan_chunk}], got "
                             f"{chunk}")
        window = window_ints(chunk)
    with torch.cuda.device(index):
        fired = torch.empty((B,), dtype=torch.int32, device=dev)
        last_prog = torch.empty_like(fired)
        err = lib.mf_block_launch(
            _vp(tabs.words["node"]), _vp(tabs.words["arc"]), _vp(fv),
            _vp(fl), _vp(active), *(_vp(x) for x in state),
            *(_vp(x) for x in (*(prof or [None] * 5),
                               *(chprof or [None] * 3))),
            _vp(fired), _vp(last_prog), B, tabs.P, tabs.N2m, tabs.A2m,
            n_in, out_last.shape[1], L, chf.shape[1], int(n_cycles),
            tabs.ops, VARIANTS.index(variant), chunk or plan_chunk, window,
            streams,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err:
        raise RuntimeError(f"mf_block kernel launch failed ({variant} "
                           "variant): "
                           + lib.fire_block_error_string(err).decode())
    return fired, last_prog


def mf_block_cuda(tabs, fv, fl, full, val, ptr, out_last, out_count, chf,
                  chv, *, n_cycles: int, active=None, prof=None,
                  chprof=None):
    """The sharded block on int32 tokens (the port's counterpart of XLA's
    fused ``MultiFabric._core_fn`` block), updating the state in place and
    returning (fired[B], last_prog[B]).  CUDA tensors launch the kernel in
    the tables' variant and count the launch in ``launches`` (unprofiled)
    or ``prof_launches``, and by variant in ``launches_by``; CPU tensors
    take :func:`mf_block`."""
    if _on_cpu(fv, full, chf, active):
        return mf_block(tabs, fv, fl, full, val, ptr, out_last, out_count,
                        chf, chv, n_cycles=n_cycles, active=active,
                        prof=prof, chprof=chprof)
    out = launch_mf(tabs, fv, fl, full, val, ptr, out_last, out_count, chf,
                    chv, n_cycles=n_cycles, active=active, prof=prof,
                    chprof=chprof)
    if prof is None:
        mf_block_cuda.launches += 1
    else:
        mf_block_cuda.prof_launches += 1
    mf_block_cuda.launches_by[tabs.variant] += 1
    return out


mf_block_cuda.launches = mf_block_cuda.prof_launches = 0
mf_block_cuda.launches_by = dict.fromkeys(VARIANTS, 0)
