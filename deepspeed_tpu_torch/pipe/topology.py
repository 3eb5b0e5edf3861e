"""Cartesian rank topology over named parallel axes: the port of
``deepspeed_tpu/pipe/topology.py`` (reference ``runtime/pipe/topology.py``:
``ProcessTopology`` :9, ``PipeModelDataParallelTopology`` :243,
``PipelineParallelGrid`` :249).

Pure rank algebra, no communication: the port's process groups belong to the
mesh (``comm/mesh.py``), whose ranks run row-major over ``AXIS_ORDER`` with
``pipe`` outermost, so a ``ProcessTopology`` over the mesh's axes in that
order gives every rank the coordinates the mesh gives it. It serves checkpoint file naming (``pipe_00-model_00``
fragments), tests that reason about coordinates, and the launcher's mapping
of processes onto mesh coordinates.
"""

from __future__ import annotations

import itertools
from collections import namedtuple
from typing import Optional, Sequence


class ProcessTopology:
    """Maps n-dimensional axis coordinates <-> linear ranks.

    Axes are ordered outermost-first: ``axes[0]`` varies slowest, matching
    both the reference's convention and ``comm.mesh.AXIS_ORDER``.
    """

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        assert len(axes) == len(dims), f"{axes} vs {dims}"
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", axes)
        self.mapping = {}
        for coord in itertools.product(*[range(d) for d in self.dims]):
            key = self.ProcessCoord(*coord)
            self.mapping[key] = len(self.mapping)

    def get_rank(self, **coord_kwargs) -> int:
        if len(coord_kwargs) != len(self.axes):
            raise ValueError(f"expected all axes {self.axes}, got {list(coord_kwargs)}")
        return self.mapping[self.ProcessCoord(**coord_kwargs)]

    def get_coord(self, rank: int):
        for coord, r in self.mapping.items():
            if r == rank:
                return coord
        raise ValueError(f"rank {rank} not in topology")

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)] if axis in self.axes else 0

    def get_axis_names(self):
        return list(self.axes)

    def world_size(self) -> int:
        out = 1
        for d in self.dims:
            out *= d
        return out

    def get_rank_repr(self, rank: int, omit_axes: Sequence[str] = ("data",), inner_sep="_", outer_sep="-") -> str:
        """Checkpoint-path fragment like ``pipe_00-model_00`` (reference
        topology.py get_rank_repr; used by pipeline layer-file names)."""
        omit = set(omit_axes)
        coord = self.get_coord(rank)
        parts = [
            f"{axis}{inner_sep}{getattr(coord, axis):02d}"
            for axis in self.axes
            if axis not in omit
        ]
        return outer_sep.join(parts)

    def filter_match(self, **filter_kwargs) -> list[int]:
        """All ranks whose coordinates match the given axis=value filters."""

        def match(coord):
            return all(getattr(coord, a) == v for a, v in filter_kwargs.items())

        return sorted(r for c, r in self.mapping.items() if match(c))

    def get_axis_list(self, axis: str, idx: int) -> list[int]:
        return self.filter_match(**{axis: idx})

    def get_axis_comm_lists(self, axis: str) -> list[list[int]]:
        """Groups of ranks that vary only along ``axis``: the reference's
        process-group construction input (the mesh makes the port's groups; these
        lists are its ``partition(axis)``)."""
        if axis not in self.axes:
            return []
        others = [a for a in self.axes if a != axis]
        lists = []
        for combo in itertools.product(*[range(self.get_dim(a)) for a in others]):
            fixed = dict(zip(others, combo))
            ranks = [
                self.get_rank(**{axis: i}, **fixed) for i in range(self.get_dim(axis))
            ]
            lists.append(ranks)
        return lists


class PipeDataParallelTopology(ProcessTopology):
    """axes = (pipe, data) — hybrid PP+DP (reference topology.py:232)."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """axes = (pipe, data, model) — 3D parallelism (reference topology.py:243)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class PipelineParallelGrid:
    """Per-rank view of the topology (reference topology.py:249): stage id,
    DP id, neighbours. The mesh carries the process groups; this answers the
    "who am I / who are my neighbours" questions for schedules and launch."""

    def __init__(self, topology: ProcessTopology, global_rank: int = 0):
        self._topo = topology
        self.global_rank = global_rank
        self.world_size = topology.world_size()
        coord = topology.get_coord(global_rank)
        self.stage_id = getattr(coord, "pipe", 0)
        self.data_parallel_id = getattr(coord, "data", 0)
        self.model_parallel_id = getattr(coord, "model", 0)
        self.pipe_parallel_size = topology.get_dim("pipe") or 1
        self.data_parallel_size = topology.get_dim("data") or 1
        self.model_parallel_size = topology.get_dim("model") or 1

    def get_stage_id(self) -> int:
        return self.stage_id

    def get_data_parallel_id(self) -> int:
        return self.data_parallel_id

    def get_pipe_parallel_world_size(self) -> int:
        return self.pipe_parallel_size

    def get_data_parallel_world_size(self) -> int:
        return self.data_parallel_size

    def get_model_parallel_world_size(self) -> int:
        return self.model_parallel_size

    def is_first_stage(self) -> bool:
        return self.stage_id == 0

    def is_last_stage(self) -> bool:
        return self.stage_id == self.pipe_parallel_size - 1

    def stage_to_global(self, stage_id: int) -> int:
        """Rank with the same non-pipe coordinates but the given stage."""
        coord = self._topo.get_coord(self.global_rank)
        kw = {a: getattr(coord, a) for a in self._topo.get_axis_names()}
        kw["pipe"] = stage_id
        return self._topo.get_rank(**kw)

    @property
    def prev_stage(self) -> Optional[int]:
        return self.stage_id - 1 if self.stage_id > 0 else None

    @property
    def next_stage(self) -> Optional[int]:
        return self.stage_id + 1 if self.stage_id < self.pipe_parallel_size - 1 else None

