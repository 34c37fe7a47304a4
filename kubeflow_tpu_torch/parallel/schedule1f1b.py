"""Static schedule construction for INTERLEAVED 1F1B.

The port's own copy of ``kubeflow_tpu/parallel/schedule1f1b.py`` (numpy
only, so it is kept near-verbatim; the port imports nothing of the JAX
package). ``tests/test_torch_pipeline.py`` holds every table against the
reference's, array for array.

The plain 1F1B tables (``parallel/pipeline.py`` ``_1f1b_tables``) come
from closed formulas; with virtual stages the slot structure is
irregular enough (per-device warmup depths, chunk cycling, wrap-edge
transfers) that a closed form is easy to get subtly wrong. So the
schedule here is CONSTRUCTED by an event-driven simulator following the
Megatron discipline — per-device warmup of ``2*(P-d-1) + (V-1)*P``
forwards, then strict 1B1F alternation with idling when the due unit's
inputs have not arrived — and then VALIDATED by an independent checker
(`check_schedule`) that re-derives every dataflow constraint from
scratch. Buffer slots for activations and cotangents are assigned by
static interval-graph colouring, so the executor performs no modular
keying at runtime: every slot of every device knows statically which
buffer entry to read or write.

Unit vocabulary: global stage s = v*P + d (chunk v lives on device
s mod P), unit (s, m) = one forward or backward of microbatch m
through stage s. Dataflow:

- F(s, m) consumes the activation produced by F(s-1, m) (ring hop
  d-1 -> d, with the wrap edge P-1 -> 0 carrying chunk boundaries);
  s = 0 reads the microbatch input directly.
- B(s, m) consumes the stored input of (s, m) (for the vjp recompute)
  and the cotangent produced by B(s+1, m) (reverse ring hop with the
  wrap edge 0 -> P-1); s = C-1 seeds from the loss cotangent.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Interleaved1F1B:
    """Static tables, all shaped (T, P) unless noted; -1 = not
    applicable at that slot. Buffer slots are per-device colourings
    (two devices may use the same slot id independently)."""

    num_slots: int
    num_stages: int           # P
    virtual_stages: int       # V
    num_microbatches: int     # M
    xbuf_slots: int           # Kx: activation buffer depth
    cbuf_slots: int           # Kc: cotangent buffer depth
    action: np.ndarray        # 0 idle / 1 forward / 2 backward
    unit_v: np.ndarray        # chunk index of the unit
    unit_m: np.ndarray        # microbatch index of the unit
    f_in: np.ndarray          # xbuf slot feeding an F unit (-1: xm[m])
    b_in: np.ndarray          # xbuf slot feeding a B unit (-1: xm[m])
    b_cot: np.ndarray         # cbuf slot feeding a B unit (-1: seed)
    act_store: np.ndarray     # xbuf slot for THIS slot's arriving act
    cot_store: np.ndarray     # cbuf slot for THIS slot's arriving cot


def build_schedule(num_microbatches: int, num_stages: int,
                   virtual_stages: int) -> Interleaved1F1B:
    """Simulate the Megatron interleaved-1F1B discipline into static
    tables. Requires M % P == 0 (microbatch groups tile the chunk
    cycle)."""
    M, P, V = num_microbatches, num_stages, virtual_stages
    if M % P:
        raise ValueError(f"num_microbatches={M} must divide by pp={P}")
    C = V * P

    def stage(v: int, d: int) -> int:
        return v * P + d

    # Per-device unit orders (Megatron): forwards sweep chunks within
    # each P-microbatch group; backwards sweep chunks in reverse.
    def forward_order(d):
        # The LAST global stage's re-forward is dropped: in the
        # custom_vjp backward, F units exist solely to produce the next
        # stage's input, and stage C-1 feeds nothing (the primal
        # already computed the real forward). Keeping it would read its
        # input slot after B(C-1, m) freed it.
        return [
            (v, g * P + j)
            for g in range(M // P)
            for v in range(V)
            for j in range(P)
            if stage(v, d) != C - 1
        ]

    def backward_order(d):
        return [
            (V - 1 - v, g * P + j)
            for g in range(M // P)
            for v in range(V)
            for j in range(P)
        ]

    f_units = {d: forward_order(d) for d in range(P)}
    b_units = {d: backward_order(d) for d in range(P)}
    warmup = {
        d: min(len(f_units[d]), 2 * (P - d - 1) + (V - 1) * P)
        for d in range(P)
    }

    f_done: dict[tuple[int, int], int] = {}   # (s, m) -> slot
    b_done: dict[tuple[int, int], int] = {}
    fi = {d: 0 for d in range(P)}
    bi = {d: 0 for d in range(P)}
    # After warmup the device alternates, starting with a backward.
    prefer_b = {d: True for d in range(P)}
    schedule: list[list[tuple[str, int, int] | None]] = []

    def f_runnable(d, t):
        if fi[d] >= len(f_units[d]):
            return False
        v, m = f_units[d][fi[d]]
        s = stage(v, d)
        return s == 0 or f_done.get((s - 1, m), t) < t

    def b_runnable(d, t):
        if bi[d] >= len(b_units[d]):
            return False
        v, m = b_units[d][bi[d]]
        s = stage(v, d)
        # Needs the vjp input (arrived via F(s-1, m)) and the incoming
        # cotangent (B(s+1, m)); the last stage seeds from the loss.
        if s > 0 and not f_done.get((s - 1, m), t) < t:
            return False
        if s < C - 1 and not b_done.get((s + 1, m), t) < t:
            return False
        return True

    # F + B units across ALL devices, minus the dropped last-stage
    # re-forwards (M of them).
    total_units = 2 * M * V * P - M
    scheduled = 0
    t = 0
    max_slots = 16 * (total_units + 2 * P)  # hard runaway stop
    while scheduled < total_units:
        if t > max_slots:
            raise RuntimeError(
                f"schedule did not converge (M={M}, P={P}, V={V})"
            )
        row: list[tuple[str, int, int] | None] = [None] * P
        # Decide all devices against the PRE-SLOT state so arrivals
        # within the same slot cannot be consumed early.
        for d in range(P):
            in_warmup = fi[d] < warmup[d]
            if in_warmup:
                choice = "F" if f_runnable(d, t) else None
            else:
                order = ("B", "F") if prefer_b[d] else ("F", "B")
                choice = None
                for kind in order:
                    if kind == "F" and f_runnable(d, t):
                        choice = "F"
                        break
                    if kind == "B" and b_runnable(d, t):
                        choice = "B"
                        break
            if choice == "F":
                v, m = f_units[d][fi[d]]
                row[d] = ("F", v, m)
            elif choice == "B":
                v, m = b_units[d][bi[d]]
                row[d] = ("B", v, m)
        for d in range(P):
            unit = row[d]
            if unit is None:
                continue
            kind, v, m = unit
            s = stage(v, d)
            if kind == "F":
                f_done[(s, m)] = t
                fi[d] += 1
                if fi[d] > warmup[d]:
                    prefer_b[d] = True
            else:
                b_done[(s, m)] = t
                bi[d] += 1
                prefer_b[d] = False  # alternate: next prefers F
            scheduled += 1
        schedule.append(row)
        t += 1
    T = len(schedule)

    # ---- static buffer assignment (interval-graph colouring) --------
    # Activation intervals per device: unit (s, m) with s > 0 stores
    # its input at F(s-1, m) + 1 and frees it after B(s, m).
    def colour(intervals):
        """intervals: {unit: (start, end)} -> ({unit: slot}, depth)."""
        events = sorted(
            intervals.items(), key=lambda kv: (kv[1][0], kv[1][1])
        )
        free: list[int] = []
        live: list[tuple[int, int]] = []  # (end, slot)
        assign = {}
        depth = 0
        for unit, (start, end) in events:
            live = [(e, sl) for (e, sl) in live if e >= start or (
                free.append(sl) or False)]
            if free:
                slot = free.pop()
            else:
                slot = depth
                depth += 1
            assign[unit] = slot
            live.append((end, slot))
        return assign, depth

    x_assign: dict[int, dict[tuple[int, int], int]] = {}
    c_assign: dict[int, dict[tuple[int, int], int]] = {}
    kx = kc = 0
    for d in range(P):
        xin = {}
        cin = {}
        for v in range(V):
            s = stage(v, d)
            for m in range(M):
                if s > 0:
                    xin[(s, m)] = (f_done[(s - 1, m)] + 1,
                                   b_done[(s, m)])
                if s < C - 1:
                    cin[(s, m)] = (b_done[(s + 1, m)] + 1,
                                   b_done[(s, m)])
        xa, kxd = colour(xin)
        ca, kcd = colour(cin)
        x_assign[d] = xa
        c_assign[d] = ca
        kx = max(kx, kxd)
        kc = max(kc, kcd)

    # ---- tables -----------------------------------------------------
    shape = (T, P)
    action = np.zeros(shape, np.int32)
    unit_v = np.full(shape, -1, np.int32)
    unit_m = np.full(shape, -1, np.int32)
    f_in = np.full(shape, -1, np.int32)
    b_in = np.full(shape, -1, np.int32)
    b_cot = np.full(shape, -1, np.int32)
    act_store = np.full(shape, -1, np.int32)
    cot_store = np.full(shape, -1, np.int32)

    for t_i, row in enumerate(schedule):
        for d, unit in enumerate(row):
            if unit is None:
                continue
            kind, v, m = unit
            s = stage(v, d)
            unit_v[t_i, d] = v
            unit_m[t_i, d] = m
            if kind == "F":
                action[t_i, d] = 1
                if s > 0:
                    f_in[t_i, d] = x_assign[d][(s, m)]
            else:
                action[t_i, d] = 2
                if s > 0:
                    b_in[t_i, d] = x_assign[d][(s, m)]
                if s < C - 1:
                    b_cot[t_i, d] = c_assign[d][(s, m)]

    # Arrivals: the producer ran at t-1 on the ring neighbour.
    for (s, m), t_f in f_done.items():
        if s + 1 >= C:
            continue  # last stage's output has no consumer
        d_to = (s + 1) % P
        act_store[t_f + 1, d_to] = x_assign[d_to][(s + 1, m)]
    for (s, m), t_b in b_done.items():
        if s == 0:
            continue  # dx of stage 0 feeds dxm, not the ring
        d_to = (s - 1) % P
        cot_store[t_b + 1, d_to] = c_assign[d_to][(s - 1, m)]

    return Interleaved1F1B(
        num_slots=T, num_stages=P, virtual_stages=V,
        num_microbatches=M, xbuf_slots=max(kx, 1),
        cbuf_slots=max(kc, 1),
        action=action, unit_v=unit_v, unit_m=unit_m,
        f_in=f_in, b_in=b_in, b_cot=b_cot,
        act_store=act_store, cot_store=cot_store,
    )


def check_schedule(sched: Interleaved1F1B) -> None:
    """Independent validity check: re-derives every constraint from
    the tables alone (does NOT reuse the simulator state). Raises
    AssertionError on any violation."""
    P, V, M = (sched.num_stages, sched.virtual_stages,
               sched.num_microbatches)
    C = V * P
    f_at: dict[tuple[int, int], int] = {}
    b_at: dict[tuple[int, int], int] = {}
    for t in range(sched.num_slots):
        for d in range(P):
            a = sched.action[t, d]
            if a == 0:
                continue
            v, m = int(sched.unit_v[t, d]), int(sched.unit_m[t, d])
            assert 0 <= v < V and 0 <= m < M
            s = v * P + d
            key = (s, m)
            if a == 1:
                assert key not in f_at, f"F{key} scheduled twice"
                f_at[key] = t
            else:
                assert key not in b_at, f"B{key} scheduled twice"
                b_at[key] = t
    # The last stage's re-forward is deliberately dropped (see
    # build_schedule.forward_order).
    assert len(f_at) == (C - 1) * M, "missing forwards"
    assert len(b_at) == C * M, "missing backwards"
    assert not any(s == C - 1 for (s, _m) in f_at), "waste F scheduled"
    for (s, m), t in f_at.items():
        if s > 0:
            assert f_at[(s - 1, m)] < t, f"F({s},{m}) before its input"
    for (s, m), t in b_at.items():
        # (No constraint against the unit's OWN forward: the backward
        # recomputes via vjp from the stored INPUT, so only the input
        # arrival and the incoming cotangent gate it.)
        if s < C - 1:
            assert b_at[(s + 1, m)] < t, f"B({s},{m}) before its seed"
        if s > 0:
            assert f_at[(s - 1, m)] < t, f"B({s},{m}) before its input"

    # Buffer discipline: replay the static slots and assert no live
    # entry is overwritten and every read was written. Store ownership
    # is resolved through reverse maps built once — (arrival slot,
    # dest device) -> unit — instead of scanning f_at/b_at per store,
    # which is O(units^2) overall and real time at production scale
    # (M=512 x P=16 x V=4 is ~65k units).
    xowner: dict[tuple[int, int], tuple[int, int]] = {}
    for (s, m), tf in f_at.items():
        if s + 1 < C:
            key = (tf + 1, (s + 1) % P)
            assert key not in xowner, f"two acts arrive at {key}"
            xowner[key] = (s + 1, m)
    cowner: dict[tuple[int, int], tuple[int, int]] = {}
    for (s, m), tb in b_at.items():
        if s > 0:
            key = (tb + 1, (s - 1) % P)
            assert key not in cowner, f"two cots arrive at {key}"
            cowner[key] = (s - 1, m)
    for d in range(P):
        xlive: dict[int, tuple[int, int]] = {}
        clive: dict[int, tuple[int, int]] = {}
        for t in range(sched.num_slots):
            xs = int(sched.act_store[t, d])
            if xs >= 0:
                assert xs < sched.xbuf_slots
                # Overwriting is only legal if the previous occupant
                # is dead (its B already ran strictly before t).
                if xs in xlive:
                    prev = xlive[xs]
                    assert b_at[prev] < t, (
                        f"xbuf[{xs}]@dev{d} overwritten live: {prev}"
                    )
                # Which unit does this arrival belong to?
                owner = xowner.get((t, d))
                assert owner is not None, f"orphan act store t={t} d={d}"
                xlive[xs] = owner
            cs = int(sched.cot_store[t, d])
            if cs >= 0:
                assert cs < sched.cbuf_slots
                if cs in clive:
                    prev = clive[cs]
                    assert b_at[prev] < t, (
                        f"cbuf[{cs}]@dev{d} overwritten live: {prev}"
                    )
                owner = cowner.get((t, d))
                assert owner is not None, f"orphan cot store t={t} d={d}"
                clive[cs] = owner
            a = sched.action[t, d]
            if a == 0:
                continue
            v, m = int(sched.unit_v[t, d]), int(sched.unit_m[t, d])
            s = v * P + d
            if a == 1 and s > 0:
                slot = int(sched.f_in[t, d])
                assert xlive.get(slot) == (s, m), (
                    f"F({s},{m}) reads wrong xbuf entry"
                )
            if a == 2:
                if s > 0:
                    slot = int(sched.b_in[t, d])
                    assert xlive.get(slot) == (s, m), (
                        f"B({s},{m}) reads wrong xbuf entry"
                    )
                if s < C - 1:
                    slot = int(sched.b_cot[t, d])
                    assert clive.get(slot) == (s, m), (
                        f"B({s},{m}) reads wrong cbuf entry"
                    )
