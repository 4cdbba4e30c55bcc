"""Exact map-statistics merges over ranks.

Port of ``ndtpso_slam_tpu/parallel/distributed.py`` on ``torch.distributed``:
several ranks ingest different scans (or shards of one scan) into one
replicated NDT map and merge the statistics with an all-reduce.  Exact, not
approximate: ``add_points`` touches only the additive open-slot accumulators
(``cur_sum``, ``cur_count``, ``cur_m2``) and the ``created``/``built`` flags,
so the sum of the ranks' deltas reproduces a serial ingestion of the same
points up to float addition order, and the window build then runs the same
on every rank from the merged state.

The port's map is updated in place, so a merge needs the state before the
ingestion: :func:`merged_fields` copies the five fields a merge reads.
Every rank ends with the same bits: each all-reduce hands every rank one
result.
"""

from __future__ import annotations

import dataclasses

import torch

from ndtpso_slam_tpu_torch.config import MapConfig
from ndtpso_slam_tpu_torch.models import ndt_map
from ndtpso_slam_tpu_torch.parallel import runtime

MERGED_FIELDS = ("cur_sum", "cur_count", "cur_m2", "created", "built")


def merged_fields(state: ndt_map.NdtMapState) -> ndt_map.NdtMapState:
    """``state`` with copies of the fields a merge reads (the rest shared):
    the ``before`` of :func:`merge_deltas`."""
    return dataclasses.replace(state, **{f: getattr(state, f).clone() for f in MERGED_FIELDS})


def sharded_update(
    state: ndt_map.NdtMapState,
    cfg: MapConfig,
    pose: torch.Tensor,
    points: torch.Tensor,
    valid: torch.Tensor,
    mesh: runtime.Mesh,
    axes,
) -> ndt_map.NdtMapState:
    """Ingest this rank's shard of points (``pose`` the same on every rank,
    or this rank's own for multi-robot) into the replicated map, then merge
    over the ranks along ``axes``: the merged map, in place."""
    before = merged_fields(state)
    ndt_map.update(state, cfg, pose, points, valid)
    return merge_deltas(before, state, mesh, axes)


def merge_deltas(
    before: ndt_map.NdtMapState, after: ndt_map.NdtMapState, mesh: runtime.Mesh, axes
) -> ndt_map.NdtMapState:
    """All-reduce the ingestion delta ``after - before`` over the ranks
    along ``axes`` into ``after``, in place: the accumulators become
    ``before + sum(delta)``; a cell any rank touched is created and
    un-built.  Two all-reduces: the float deltas [C+1, 5], and the count
    delta beside each rank's changed flag [C+1, 2] (int32)."""
    floats = torch.cat([after.cur_sum - before.cur_sum, after.cur_m2 - before.cur_m2], dim=-1)
    changed = (after.created != before.created) | (after.built != before.built)
    ints = torch.stack([after.cur_count - before.cur_count, changed.to(torch.int32)], dim=-1)
    floats = runtime.all_reduce(mesh, floats, axes)
    ints = runtime.all_reduce(mesh, ints, axes)
    d_count = ints[:, 0]
    touched = (ints[:, 1] > 0) | (d_count > 0)
    after.cur_sum.copy_(before.cur_sum + floats[:, :2])
    after.cur_m2.copy_(before.cur_m2 + floats[:, 2:])
    after.cur_count.copy_(before.cur_count + d_count)
    torch.logical_or(before.created, touched, out=after.created)
    torch.logical_and(before.built, ~touched, out=after.built)
    return after
