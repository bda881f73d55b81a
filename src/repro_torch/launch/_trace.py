"""Profiler ranges over plain functions, and the rule that moves the device
kernels under them into groups of their own: what ``trace_serve`` and
``trace_train`` share.

A launcher wraps the functions it wants split out in ``torch.profiler``
ranges while its traced pass runs (``patched`` with ``ranged``), names a
group for each range, and the groups a range's kernels may leave for it
(``moved_from``).  ``attribute`` then decides, for each kernel of the
trace, which range takes it:

- a kernel under one or more ranges goes to the outermost (the longest)
  one that takes its group;
- a backward node (``BACKWARD``) made by a forward op that ran under a
  range takes that range's group's kernels that lie under no range.  The
  profiler's sequence number and forward thread tie the two: sequence
  numbers count per thread, and a recompute's ops, run on the backward's
  thread, reuse the numbers of the forward's.  Remat's
  recompute runs inside the first backward node that unpacks a saved
  tensor of its region; a launcher that ranges the checkpointed function
  (a fence: a range of group ``None``, which takes nothing) keeps the
  whole recompute out of that node, and the recompute's own ranges take
  its kernels as the forward's took them.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

GEMM_MARKS = ("gemm", "xmma", "nvjet", "cutlass", "cublas")
GEMMS = "GEMM (torch.matmul)"
OTHER_OPS = "other PyTorch ops"
BACKWARD = "autograd::engine::evaluate_function"


def is_gemm(name: str) -> bool:
    return any(m in name.lower() for m in GEMM_MARKS)


def ranged(fn, name: str):
    """``fn`` with each call under the profiler range ``name``."""
    def call(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def patched(replacements):
    """Set each ``(owner, attribute, value)`` of ``replacements`` while the
    block runs, and restore the old values after it."""
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in replacements]
    for owner, attr, value in replacements:
        setattr(owner, attr, value)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)


def _launched(ev):
    return ev.kernels


def _kernels(ev, launched, skip=()):
    """The kernels launched by a profiler CPU event and its descendants,
    not entering a descendant whose name is in ``skip``."""
    out = list(launched(ev))
    for child in ev.cpu_children:
        if child.name not in skip:
            out += _kernels(child, launched, skip)
    return out


def _ops(ev):
    yield ev
    for child in ev.cpu_children:
        yield from _ops(child)


def attribute(events, ranges, moved_from, group, launched=_launched):
    """Kernels that leave their own group for a range's -> {kernel id:
    (from group, to group, us)}.

    ``ranges`` maps a range's name to its group (``None``: a fence, which
    takes no kernel and names no backward node); ``moved_from[g]`` lists
    the groups that range group ``g``'s kernels leave (``None``: every
    group; ``g`` absent: only ``OTHER_OPS``); ``group(name)`` is a kernel's
    own group; ``launched(ev)`` the kernels an event launched itself (a
    device kernel's ``name`` and ``duration`` in us are read)."""
    cpu = torch.autograd.DeviceType.CPU
    spans = [ev for ev in events if ev.name in ranges and ev.device_type == cpu]
    taken = {}                     # kernel id -> (range span us, from, to, us)
    made_by = {}                   # (thread, sequence number) -> range group
    # the outer ranges first, so the innermost range an op ran under names
    # the backward node it made
    for ev in sorted(spans, key=lambda e: -e.time_range.elapsed_us()):
        to = ranges[ev.name]
        if to is None:
            continue
        span = ev.time_range.elapsed_us()
        allowed = moved_from.get(to, (OTHER_OPS,))
        for k in _kernels(ev, launched):
            src = group(k.name)
            if (allowed is None or src in allowed) and \
                    span > taken.get(id(k), (-1.0,))[0]:
                taken[id(k)] = (span, src, to, k.duration)
        for op in _ops(ev):
            if op.sequence_nr >= 0:
                made_by[op.thread, op.sequence_nr] = to
    for ev in events:
        to = made_by.get((ev.fwd_thread, ev.sequence_nr)) \
            if ev.name.startswith(BACKWARD) and ev.sequence_nr >= 0 else None
        if to is None:
            continue
        allowed = moved_from.get(to, (OTHER_OPS,))
        for k in _kernels(ev, launched, skip=ranges):
            src = group(k.name)
            if (allowed is None or src in allowed) and id(k) not in taken:
                taken[id(k)] = (0.0, src, to, k.duration)
    return {key: (src, to, us) for key, (_, src, to, us) in taken.items()}


def regroup(per_kernel, taken, group):
    """Device time and launches by group: ``per_kernel`` {kernel name:
    [us, launches]} summed by ``group(name)``, then ``attribute``'s kernels
    moved from their group to their range's -> {group: [us, launches]}."""
    groups = defaultdict(lambda: [0.0, 0])
    for name, (us, n) in per_kernel.items():
        groups[group(name)][0] += us
        groups[group(name)][1] += n
    for src, to, us in taken.values():
        groups[src][0] -= us
        groups[src][1] -= 1
        groups[to][0] += us
        groups[to][1] += 1
    return groups
