"""Multi-fabric sharded execution: one graph as P communicating fabrics
(PyTorch port of ``repro.core.multifabric``).

A :class:`~repro_torch.core.partition.Partition` splits the graph into P
regions; each region compiles to its own fabric plan (the same
:func:`repro_torch.core.engine._plan` layout the solo engine uses,
including the role-ordered arc permutation under ``optimize``) and every
inter-region arc becomes a *token channel*: a (full, value) register
pair that both endpoint regions see, mirrored every cycle into the
producer region's *out-copy* slot and the consumer region's *in-copy*
slot.

Lockstep channel semantics (DESIGN.md §14).  A depth-1 arc couples its
endpoints in both directions every cycle, so every region executes the
global cycle against one snapshot: mirror the channel registers into both
copies, run the solo engine's cycle (feed -> fire -> drain) on the
region's own nodes, then merge each channel from its producer region's
push and its consumer region's consume, ``full' = (full & ~consumed) |
pushed`` — the register update an internal arc performs in the solo
engine.  So every :class:`~repro_torch.core.engine.EngineResult` field
(outputs, counts, cycles, fired, node_fires, the merged profile) equals
the solo fabric's, and the JAX package's partitioned engine's.

Placement.  The JAX package runs the regions under ``shard_map`` on a
device mesh or under ``vmap`` on one device.  Here the regions are
stacked on one device (``placement="auto"`` or ``"vmap"``): on the
``"cuda"`` backend a block is one launch of the sharded block kernel
(:func:`repro_torch.kernels.multifabric.mf_block_cuda`: a stream's
regions in one warp, or one CTA per stream and one warp per region for
larger regions; its plain PyTorch version with ``device="cpu"``), on ``"torch"`` it is
:func:`~repro_torch.kernels.multifabric.mf_block` in the token dtype.
Placement across several cards (``"shard_map"``) is ROADMAP Queue A 10b.

The host block loop and its accounting are the JAX package's
``MultiFabric.run_batch`` (``dispatches`` counts blocks on both
backends); the engine's slot API runs the same blocks per slot.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import (EngineResult, from_carrier, pack_feeds,
                                     resolve_device, to_carrier)
from repro_torch.core.graph import Graph, Op
from repro_torch.core.partition import Partition
from repro_torch.kernels import multifabric as kmf
from repro_torch.kernels.dataflow_fire import plan_arrays

PLACEMENTS = ("auto", "vmap", "shard_map")


class MultiFabric:
    """P cooperating fabric plans and their token channels, for one
    partitioned :class:`~repro_torch.core.engine.DataflowEngine`
    (``backend`` ``"cuda"`` or ``"torch"``), which delegates ``run``,
    ``run_batch`` and the blocks of its slot API here."""

    def __init__(self, graph: Graph, part: Partition, *, backend="cuda",
                 dtype=np.int32, block_cycles: int = 16,
                 optimize: bool = False, profile: bool = False,
                 max_cycles: int = 100_000, device="cuda",
                 placement: str = "auto"):
        if placement not in PLACEMENTS:
            raise ValueError(f"placement {placement!r} not in {PLACEMENTS}")
        if placement == "shard_map":
            raise NotImplementedError(
                "placement='shard_map' (regions on several cards, "
                "torch.distributed) is not ported yet: ROADMAP Queue A 10b")
        self.graph = graph
        self.part = part
        self.P = part.P
        self.backend = backend
        self.dtype = np.dtype(dtype)
        self.block_cycles = int(block_cycles)
        self.optimize = bool(optimize)
        self.profile = bool(profile)
        self.max_cycles = int(max_cycles)
        self.device = resolve_device(device)
        self._build_tables()
        self.tabs = kmf.device_tables(self.tables, self.device)
        if backend == "cuda" and self.device.type == "cuda" \
                and self.tabs.words is None:
            raise ValueError("the sharded block kernel cannot run "
                             f"{self.tabs.too_large}")

    # ------------------------------------------------------------ plan build
    def _build_tables(self):
        g, part = self.graph, self.part
        P, assign = self.P, part.assign
        g.validate()
        prod = {a: ns[0] for a, ns in g.producers().items()}
        cons = g.consumers()
        garc = {a: i for i, a in enumerate(g.arcs)}

        # inter-region arcs -> channels (const buses are replicated,
        # never cut; producer-less / consumer-less arcs stay local)
        self.channels = [
            a for a in g.arcs
            if a not in g.consts and a in prod and a in cons
            and assign[prod[a]] != assign[cons[a][0]]]
        ch_set = set(self.channels)
        self.C = C = len(self.channels)
        Cp = max(C, 1)

        region_nodes = part.regions()
        self.subs: list[Graph] = []
        for r in range(P):
            sub = Graph(name=f"{g.name}@r{r}of{P}")
            used: set[str] = set()
            for i in region_nodes[r]:
                sub.nodes.append(g.nodes[i])
                used.update(g.nodes[i].inputs)
                used.update(g.nodes[i].outputs)
            for a, v in g.consts.items():
                # replicate consumed const buses; a (degenerate)
                # consumer-less const drains from region 0 like solo
                if a in used or (r == 0 and a not in cons):
                    sub.consts[a] = v
            for a, v in g.inits.items():
                # a cut init arc's one-shot token lives in the channel
                # register; local inits stay with their consumer region
                if a in ch_set:
                    continue
                if assign[cons[a][0]] == r:
                    sub.inits[a] = v
            self.subs.append(sub)
        rtabs = [plan_arrays(sub, optimize=self.optimize)
                 for sub in self.subs]
        self.plans = plans = [t["plan"] for t in rtabs]

        inputs, outputs = g.input_arcs(), g.output_arcs()
        env_in = [[a for a in p["input_arcs"] if a not in ch_set]
                  for p in plans]
        env_out = [[a for a in p["output_arcs"] if a not in ch_set]
                   for p in plans]
        assert sorted(a for e in env_in for a in e) == sorted(inputs)
        assert sorted(a for e in env_out for a in e) == sorted(outputs)
        owner_in = {a: r for r in range(P) for a in env_in[r]}
        owner_out = {a: r for r in range(P) for a in env_out[r]}

        # the flat layout: region r owns node rows r*N2m .. (its plan's,
        # the dummy row, pad rows) and slots r*A2m .. (its plan's arcs,
        # FULL_PAD, EMPTY_PAD, pad slots)
        N2m = max(len(s.nodes) for s in self.subs) + 1
        A2m = max(p["A"] + 2 for p in plans)
        self.N2m, self.A2m = N2m, A2m
        PN, PA = P * N2m, P * A2m
        sl = lambda r, a: r * A2m + plans[r]["aidx"][a]   # noqa: E731
        opcode = np.full((PN,), int(Op.SINK), np.int32)
        in_idx = np.zeros((PN, 3), np.int32)
        out_idx = np.zeros((PN, 2), np.int32)
        arc = {k: np.zeros((PA,), np.int32) for k in (
            "prod_node", "prod_slot", "cons_node", "cons_slot",
            "const_mask", "occ_mask")}
        full0 = np.zeros((PA,), np.int32)
        val0 = np.zeros((PA,), self.dtype)
        node_back = np.full((PN,), -1, np.int64)
        arc_back = np.full((PA,), -1, np.int64)
        for r, (sub, t, p) in enumerate(zip(self.subs, rtabs, plans)):
            n0, a0, nr, A = r * N2m, r * A2m, len(sub.nodes), p["A"]
            # pad node rows copy the dummy row: inputs and outputs on
            # EMPTY_PAD, never ready
            opcode[n0:n0 + N2m] = t["opcode"][nr]
            in_idx[n0:n0 + N2m] = a0 + t["in_idx"][nr]
            out_idx[n0:n0 + N2m] = a0 + t["out_idx"][nr]
            opcode[n0:n0 + nr + 1] = t["opcode"]
            in_idx[n0:n0 + nr + 1] = a0 + t["in_idx"]
            out_idx[n0:n0 + nr + 1] = a0 + t["out_idx"]
            # pad slots: no producer, no consumer (the dummy row's)
            arc["prod_node"][a0:a0 + A2m] = n0 + nr
            arc["cons_node"][a0:a0 + A2m] = n0 + nr
            for k in ("prod_node", "cons_node"):
                arc[k][a0:a0 + A + 2] = n0 + t[k]
            for k in ("prod_slot", "cons_slot", "const_mask"):
                arc[k][a0:a0 + A + 2] = t[k]
            full0[a0 + p["FULL_PAD"]] = 1
            for a, v in {**sub.consts, **sub.inits}.items():
                full0[sl(r, a)] = 1
                val0[sl(r, a)] = v
            node_back[n0:n0 + nr] = np.asarray(
                region_nodes[r], np.int64)[p["node_perm"]]
            for a in p["arcs"]:
                if a not in ch_set:
                    arc_back[sl(r, a)] = garc[a]
                    arc["occ_mask"][sl(r, a)] = 1

        empty0 = plans[0]["EMPTY_PAD"]      # region 0's, for pad rows
        in_slot = np.asarray([sl(owner_in[a], a) for a in inputs]
                             or [empty0], np.int32)
        out_slot = np.asarray([sl(owner_out[a], a) for a in outputs]
                              or [empty0], np.int32)
        ch_in = np.zeros((C,), np.int32)
        ch_out = np.zeros((C,), np.int32)
        self.ch_full0 = np.zeros((Cp,), np.int32)
        self.ch_val0 = np.zeros((Cp,), self.dtype)
        self.ch_rows = np.zeros((C,), np.int64)
        for c, a in enumerate(self.channels):
            ch_out[c] = sl(assign[prod[a]], a)
            ch_in[c] = sl(assign[cons[a][0]], a)
            self.ch_rows[c] = garc[a]
            if a in g.inits:
                self.ch_full0[c] = 1
                self.ch_val0[c] = g.inits[a]
        self.tables = dict(
            P=P, N2m=N2m, A2m=A2m, opcode=opcode, in_idx=in_idx,
            out_idx=out_idx, **arc, in_slot=in_slot, out_slot=out_slot,
            ch_in=ch_in, ch_out=ch_out, feed_rows=len(inputs),
            drain_rows=len(outputs))
        self.full0, self.val0 = full0, val0
        self.node_back, self.arc_back = node_back, arc_back
        self.inputs, self.outputs = inputs, outputs

    # ----------------------------------------------------------- state
    def state0_rows(self):
        """(full0[PA] int32, val0[PA] of the token dtype) of a fresh slot,
        channel slots empty (their registers are the channels')."""
        return self.full0, self.val0

    def _carrier(self, x):
        return to_carrier(x, self.dtype, self.device)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.int32, device=self.device)

    def channels0(self, B: int) -> dict:
        """Fresh channel state of B slots: the registers ``chf``/``chv``
        [B, Cp] (a cut init arc's token in place) and, profiled, the
        three channel counters ``chprof``."""
        Cp = self.ch_full0.shape[0]
        return dict(
            chf=torch.as_tensor(self.ch_full0, device=self.device).repeat(
                B, 1),
            chv=self._carrier(self.ch_val0).repeat(B, 1),
            chprof=tuple(self._zeros(B, Cp) for _ in range(3))
            if self.profile else None)

    def reset_channels(self, mf: dict, ids) -> None:
        """Fresh channel state in the rows ``ids`` (in place)."""
        mf["chf"][ids] = torch.as_tensor(self.ch_full0, device=self.device)
        mf["chv"][ids] = self._carrier(self.ch_val0)
        for x in mf["chprof"] or ():
            x.index_fill_(0, ids, 0)

    def counters0(self, B: int) -> tuple:
        """Fresh node and arc counters (nf, si, so [B, P*N2m]; ab, ahw
        [B, P*A2m])."""
        PN, PA = self.P * self.N2m, self.P * self.A2m
        return (self._zeros(B, PN), self._zeros(B, PN), self._zeros(B, PN),
                self._zeros(B, PA), self._zeros(B, PA))

    def block(self, fv, fl, full, val, ptr, out_last, out_count, mf,
              active, prof, n_cycles: int):
        """One K-cycle sharded block of every slot, in place: the kernel
        (its plain version on CPU tensors) on ``"cuda"``, the stacked
        PyTorch program on ``"torch"``.  Returns (fired[B], last_prog[B])
        on the host, one read."""
        args = (self.tabs, fv, fl, full, val, ptr, out_last, out_count,
                mf["chf"], mf["chv"])
        kw = dict(n_cycles=n_cycles, active=active, prof=prof,
                  chprof=mf["chprof"] if prof is not None else None)
        if self.backend == "cuda":
            f, lp = kmf.mf_block_cuda(*args, **kw)
        else:
            f, lp = kmf.mf_block(*args, **kw, dtype=self.dtype)
        return torch.stack([f, lp]).cpu().numpy()

    # ------------------------------------------------------------ run paths
    def run(self, feeds=None, max_cycles: int | None = None) -> EngineResult:
        return self.run_batch([feeds or {}], max_cycles)[0]

    def run_batch(self, feeds_batch, max_cycles: int | None = None
                  ) -> list[EngineResult]:
        max_cycles = max_cycles or self.max_cycles
        feeds_batch = list(feeds_batch)
        B = len(feeds_batch)
        L = max([1] + [np.shape(v)[0] for f in feeds_batch
                       for v in (f or {}).values()])
        packed = [pack_feeds(self.inputs, f, (), self.dtype, pad_rows=1,
                             min_len=L) for f in feeds_batch]
        fv = self._carrier(np.stack([x for x, _ in packed]))
        fl = torch.as_tensor(np.stack([x for _, x in packed]),
                             device=self.device)
        full = torch.as_tensor(self.full0, device=self.device).repeat(B, 1)
        val = self._carrier(self.val0).repeat(B, 1)
        ptr = self._zeros(B, fl.shape[1])
        n_out = len(self.tables["out_slot"])
        out_last = self._carrier(np.zeros((B, n_out), self.dtype))
        out_count = self._zeros(B, n_out)
        mf = self.channels0(B)
        prof = self.counters0(B) if self.profile else None
        base = dispatches = 0
        last = np.zeros((B,), np.int64)
        fired = np.zeros((B,), np.int64)
        # the JAX package's host loop, its accounting verbatim
        while True:
            nb = min(self.block_cycles, max_cycles - base)
            f, lp = self.block(fv, fl, full, val, ptr, out_last, out_count,
                               mf, None, prof, nb)
            dispatches += 1
            fired += f
            last = np.where(lp > 0, base + lp, last)
            base += nb
            if (lp < nb).all() or base >= max_cycles:
                break
        ol = from_carrier(out_last, self.dtype)
        oc = out_count.cpu().numpy()
        hprof = hch = None
        if self.profile:
            hprof = [x.cpu().numpy() for x in prof]
            hch = [x.cpu().numpy() for x in mf["chprof"]]
        return [self.result(
            ol[b], oc[b], int(min(last[b] + 1, max_cycles)), int(fired[b]),
            dispatches, None if hprof is None else
            ([x[b] for x in hprof], [x[b] for x in hch], base))
            for b in range(B)]

    def result(self, out_last, out_count, cycles, fired, dispatches,
               prof=None) -> EngineResult:
        """One stream's EngineResult from its host rows; ``prof`` is
        (node and arc counter rows, channel counter rows, profiled
        cycles)."""
        profile = node_fires = None
        if prof is not None:
            profile = self.merged_profile(*prof[:2], cycles=prof[2],
                                          dispatches=dispatches)
            node_fires = profile.node_fires
        return EngineResult(
            outputs={a: out_last[k] for k, a in enumerate(self.outputs)},
            counts={a: int(out_count[k]) for k, a in enumerate(self.outputs)},
            cycles=cycles, fired=fired, dispatches=dispatches,
            node_fires=node_fires, profile=profile)

    def merged_profile(self, prof, chprof, cycles: int, dispatches: int):
        """Graph-order FabricProfile from one stream's flat counters (nf,
        si, so [P*N2m]; ab, ahw [P*A2m]) and its channel counters."""
        from repro_torch.obs.profile import FabricProfile
        nf, si, so, ab, ahw = [np.asarray(x, np.int64) for x in prof]
        cb, chw, cpu = [np.asarray(x, np.int64)[:self.C] for x in chprof]
        N, A = len(self.graph.nodes), len(self.graph.arcs)
        gnf, gsi, gso = (np.zeros((N,), np.int64) for _ in range(3))
        gab, gahw = (np.zeros((A,), np.int64) for _ in range(2))
        nv = self.node_back >= 0
        gnf[self.node_back[nv]] = nf[nv]
        gsi[self.node_back[nv]] = si[nv]
        gso[self.node_back[nv]] = so[nv]
        av = self.arc_back >= 0
        gab[self.arc_back[av]] = ab[av]
        gahw[self.arc_back[av]] = ahw[av]
        if self.C:
            gab[self.ch_rows] = cb
            gahw[self.ch_rows] = chw
        node_names, arc_names = FabricProfile.names_for(self.graph)
        return FabricProfile(
            node_names=node_names, arc_names=arc_names,
            node_fires=gnf, stall_in=gsi, stall_out=gso,
            arc_busy=gab, arc_hw=gahw, cycles=int(cycles),
            dispatches=int(dispatches),
            ch_names=list(self.channels),
            ch_busy=cb if self.C else None,
            ch_hw=chw if self.C else None,
            ch_pushes=cpu if self.C else None,
            ch_depth=self.block_cycles)
