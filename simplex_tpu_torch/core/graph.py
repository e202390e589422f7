"""The default pivot step replayed as one CUDA graph.

The default step on dense A (Dantzig pricing over all of A, no shadow, no
segments, no candidate buffer, eager rank-1 updates, no bounds, Bland's rule
off; :meth:`StepGraphs.captures`) has no host branch between its kernels,
and its shapes are fixed. Run eagerly, its launches cost the host more time
than the card spends on them. :class:`StepGraphs`, kept on the single-card
hopper backend (``kernels.dispatch.get_backend``), records the eager step
once with ``torch.cuda.CUDAGraph`` and replays it:
pricing (both passes), the entering column and its exact reduced cost, the
ftran GEMV, ``pivot_tail``, ``rank1_update``, the packing of the
control words and their copy into a pinned host buffer of the graph's own.
The same kernels get the same arguments, so a replay gives the eager step's
results bit for bit.

A graph holds addresses, so graphs are kept by key: the addresses, shapes
and dtypes of A, c and B_inv, whether the state carries the perturbation,
and the option scalars the launches bake in. B_inv is updated in place, as
eagerly; a new B_inv (a restart, a re-inversion) is a new key. A key is
captured only once it has run one eager step, so a short solve pays for no
capture. At most ``MAX_KEYS`` keys are kept.

Buffers. Each key has two slots, each the three output blocks of
``pivot_tail`` (x_b, y, c_b, basis, iters, status, degen: views of them), and
two graphs: graph i reads slot i and writes slot 1 - i. So a state returned
by step k (in one slot) stays valid through step k + 1, which writes the
other; the benchmark's step recorder copies a step's input basis only after
the step returns. A state that is not the last replay's output is copied
into the slot it shares leaves with (else into the one the last replay did
not write) before the replay. last_refac and the perturbation's rounds and
flag, which the step passes through, are copied as int32 words into one
block per key when they change; the graph's packing reads them there, so it
is one concatenation. ``core.solver._pivot_loop`` hands no state back that
shares memory with a slot (:meth:`StepGraphs.detach`).

Control words. An event is recorded after each replay; ``step.read_control``
reads a replay's output by waiting on that event alone and reading the
replay's pinned words (:meth:`StepGraphs.control_block`), so a replay
enqueued after it (``core.solver._pivot_loop`` runs one step ahead) does not
hold the read back. Each graph has its own words: replay k + 1 does not
overwrite those of replay k, and replay k + 2 comes only after they are read.

Counters: ``step.graph_steps`` (captured, replayed, eager, and ahead: replays
from a replay's output whose control words the host has not read); a replay
adds to ``hopper.launches`` and ``hopper.pricing_layouts`` the counts its capture
recorded (a capture launches nothing, so the counts it made are taken back),
so the counts a pivot are those of the eager step. While spans are recorded,
a replay is a ``graph`` span (of kind ``ahead`` where it counts so) with a
``launch:pivot_graph`` mark before it.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import types
from typing import Optional

import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch import spans
from simplex_tpu_torch.core import step as _step
from simplex_tpu_torch.core.state import SolverState
from simplex_tpu_torch.kernels import hopper

MAX_KEYS = 2
# the counters a replay adds to as the eager step would
_COUNTERS = (hopper.launches, hopper.pricing_layouts)
# the leaves a slot holds, and those of them the step reads
_LEAVES = ("x_b", "y", "c_b", "basis", "iters", "status", "degen")
_READ = ("x_b", "y", "c_b", "basis", "iters", "degen")


def _key(prob, state, opts) -> tuple:
    A, c, B = prob.A, prob.c, state.B_inv
    return (
        A.data_ptr(), A.shape, A.stride(), A.dtype, c.data_ptr(), c.shape, c.dtype,
        B.data_ptr(), B.shape, B.dtype, state.pert is not None, opts.resolve_eps(),
        opts.pivot_tol, opts.feas_tol, opts.ratio == "harris", opts.degen_tol, opts.bland_after,
    )


def _passed(state) -> tuple:
    """The leaves the step passes through that the control words hold."""
    if state.pert is None:
        return (state.last_refac,)
    return state.last_refac, state.pert.rounds, state.pert.on


class _Slot:
    """One set of the step's O(m) leaves and scalars: ``pivot_tail``'s
    output blocks and the views the step's state takes of them."""

    def __init__(self, dev, dtype, m: int):
        self.blocks = hopper.tail_blocks(dev, dtype, m)
        t = hopper.tail_outputs(self.blocks, dtype)
        for name in _LEAVES:
            setattr(self, name, getattr(t, name))

    def shares(self, state) -> bool:
        return any(getattr(state, name) is getattr(self, name) for name in _READ)


class _Key:
    """The two slots and two graphs of one key, and every tensor whose
    address a captured launch took (A, c, B_inv, the slots, the words, the
    capture stream's pricing scratch)."""

    def __init__(self, prob, state, stream):
        B = state.B_inv
        self.slots = (_Slot(B.device, B.dtype, B.shape[0]), _Slot(B.device, B.dtype, B.shape[0]))
        self.graphs: list = [None, None]
        self.host: list = [None, None]  # graph i's control words, pinned on the host
        self.done = (torch.cuda.Event(), torch.cuda.Event())  # recorded after the replay that wrote slot j
        self.unread = [False, False]  # the control words of slot j's last replay are not read yet
        self.launched: tuple = ({}, {})  # what a replay adds to each of _COUNTERS
        self.words = torch.empty(len(_passed(state)), dtype=torch.int32, device=B.device)
        self.words_of: Optional[tuple] = None  # the tensors the words hold
        self.written = 1  # the slot the last replay wrote: the first load goes to slot 0
        self.keep = (prob.A, prob.c, B, hopper.pricing_scratch(prob.A, prob.c.dtype, stream))

    def source(self, state) -> int:
        """The slot the step reads ``state`` from: the one that holds its
        leaves, the last written first; else the other."""
        for i in (self.written, 1 - self.written):
            if self.slots[i].shares(state):
                return i
        return 1 - self.written

    def output_of(self, state) -> Optional[int]:
        """The slot whose status, iters and degen are ``state``'s, as a
        replay wrote them, or None."""
        for j, slot in enumerate(self.slots):
            if state.status is slot.status and state.iters is slot.iters and state.degen is slot.degen:
                return j
        return None

    def load(self, state, i: int) -> None:
        slot = self.slots[i]
        for name in _READ:
            src, dst = getattr(state, name), getattr(slot, name)
            if src is not dst:
                dst.copy_(src)
        passed = _passed(state)
        if self.words_of is None or any(a is not b for a, b in zip(passed, self.words_of)):
            for word, src in zip(self.words, passed):
                word.copy_(src)
            self.words_of = passed

    def passes(self, state) -> bool:
        """Whether the words hold ``state``'s passed-through leaves."""
        return self.words_of is not None and all(a is b for a, b in zip(_passed(state), self.words_of))


class StepGraphs:
    """The captured default steps of one backend, by key (module docstring).
    :meth:`step` runs a step that :meth:`takes`; :meth:`ready` says whether
    the step from a state would replay a captured graph ahead of its control
    read; :meth:`control_block` gives ``step.read_control`` a replay's
    control words; :meth:`detach` copies a state out of the slots."""

    def __init__(self):
        self._keys: collections.OrderedDict = collections.OrderedDict()
        self._seen: collections.OrderedDict = collections.OrderedDict()  # keys that ran eagerly
        self._streams: dict = {}  # device -> capture stream

    @staticmethod
    def captures(prob, state, opts, ctl) -> bool:
        """Whether the step is the default one (module docstring) that a
        graph records, the device aside."""
        return (
            opts.pricing == "dantzig"
            and opts.update_defer == 0
            and not isinstance(prob.A, _sp.SparseA)
            and prob.A_price is None
            and prob.u is None
            and state.U is None
            and state.cand is None
            and state.e is None
            and state.at_upper is None
            and not _step._partial_active(opts, prob)
            and not _step.bland_on(opts, ctl.degen)
        )

    @staticmethod
    def takes(prob, state, opts, ctl) -> bool:
        """:meth:`captures` on CUDA tensors: the step runs from the graphs."""
        return StepGraphs.captures(prob, state, opts, ctl) and prob.A.is_cuda and state.B_inv.is_cuda

    def step(self, prob, state, opts, backend, ctl) -> SolverState:
        """One default step: eager the first time its key is seen, then by
        replay, captured on first need."""
        key = _key(prob, state, opts)
        entry = self._keys.get(key)
        if entry is not None:
            self._keys.move_to_end(key)
        else:
            if key not in self._seen:
                self._remember(self._seen, key, True)
                _step.graph_steps["eager"] += 1
                return _step.eager_step(prob, state, opts, backend, ctl)
            entry = _Key(prob, state, self._stream(state))
            self._remember(self._keys, key, entry)
        i = entry.source(state)
        ahead = entry.unread[i] and entry.output_of(state) == i
        span = spans.start("graph", "ahead" if ahead else "")
        entry.load(state, i)
        if entry.graphs[i] is None:
            self._capture(entry, i, prob, state, opts, backend, ctl)
        spans.mark("launch:pivot_graph")
        entry.graphs[i].replay()
        entry.done[1 - i].record()
        spans.stop(span)
        for counter, launched in zip(_COUNTERS, entry.launched):
            for name, n in launched.items():
                counter[name] += n
        _step.graph_steps["replayed"] += 1
        _step.graph_steps["ahead"] += ahead
        entry.written = 1 - i
        entry.unread[1 - i] = True
        out = entry.slots[1 - i]
        return SolverState(
            B_inv=state.B_inv, x_b=out.x_b, y=out.y, c_b=out.c_b, basis=out.basis,
            iters=out.iters, status=out.status, degen=out.degen,
            last_refac=state.last_refac, pert=state.pert,
        )

    def _stream(self, state) -> torch.cuda.Stream:
        """The capture stream of the state's device."""
        dev = state.B_inv.device
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                # cuBLAS sets itself up on a stream's first product: not inside a capture
                torch.mv(state.B_inv, state.y)
                torch.dot(state.y, state.y)
        return stream

    def _remember(self, table, key, value) -> None:
        table[key] = value
        table.move_to_end(key)
        while len(table) > MAX_KEYS:
            table.popitem(last=False)

    def _capture(self, entry: _Key, i: int, prob, state, opts, backend, ctl) -> None:
        """Record the eager step from slot i into slot 1 - i and the packing
        of its control words, on the key's capture stream."""
        src, dst = entry.slots[i], entry.slots[1 - i]
        stream = self._streams[state.B_inv.device]
        # the step's input as the graph reads it: the slot, and the words
        # in place of the passed-through leaves (int32, so that the packing
        # converts nothing)
        words = entry.words.unbind(0)
        pert = None
        if state.pert is not None:
            pert = type(state.pert)(w=state.pert.w, rounds=words[1], on=words[2])
        ins = SolverState(
            B_inv=state.B_inv, last_refac=words[0], pert=pert,
            **{name: getattr(src, name) for name in _LEAVES},
        )
        cap = types.SimpleNamespace(**vars(backend))
        cap.pivot_tail = functools.partial(backend.pivot_tail, out=dst.blocks)
        # status, iters, degen and the passed-through words
        host = torch.empty(3 + len(words), dtype=torch.int32, pin_memory=True)
        before = [dict(counter) for counter in _COUNTERS]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(stream):
                # thread-local: the profiler's own threads may call the runtime meanwhile
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    new = _step.eager_step(prob, ins, opts, cap, ctl)
                    packed = _step.pack_control(_step.control_fields(new, opts)[0])
                    host.copy_(packed, non_blocking=True)
                finally:
                    graph.capture_end()
        finally:
            # nothing ran: the captured launches count at each replay
            entry.launched = tuple(
                {k: v - was[k] for k, v in counter.items() if v != was[k]}
                for counter, was in zip(_COUNTERS, before)
            )
            for counter, was in zip(_COUNTERS, before):
                counter.update(was)
        entry.graphs[i], entry.host[i] = graph, host
        _step.graph_steps["captured"] += 1

    def _output(self, state) -> Optional[tuple]:
        """``(entry, slot)`` of the replay whose output ``state`` is, or None."""
        for entry in self._keys.values():
            j = entry.output_of(state)
            if j is not None:
                return entry, j
        return None

    def ready(self, prob, state, opts) -> bool:
        """Whether ``state`` is the output of a replay whose control words
        the host has not read, and the default step from it would replay a
        graph already captured: the graphs' part of the rule by which the
        solve loop runs a step ahead (``core.solver.may_run_ahead``)."""
        found = self._output(state)
        if found is None:
            return False
        entry, j = found
        return (entry.unread[j] and entry.graphs[j] is not None
                and self._keys.get(_key(prob, state, opts)) is entry)

    def control_block(self, state) -> Optional[tuple]:
        """``(event, words)`` when ``state`` is a replay's output as to every
        control word: the event recorded after that replay, and the pinned
        int32 words it copied, to be read once the event has completed. Else
        None."""
        found = self._output(state)
        if found is None or not found[0].passes(state):
            return None
        entry, j = found
        entry.unread[j] = False
        return entry.done[j], entry.host[1 - j]

    def detach(self, state: SolverState) -> SolverState:
        """``state`` with every leaf that lies in a slot copied out, so
        that no later replay writes it."""
        held = {
            block.untyped_storage().data_ptr()
            for entry in self._keys.values() for slot in entry.slots for block in slot.blocks
        }
        if not held:
            return state
        copies = {}
        for name in _LEAVES:
            t = getattr(state, name)
            if t.untyped_storage().data_ptr() in held:
                copies[name] = t.clone()
        return dataclasses.replace(state, **copies) if copies else state
