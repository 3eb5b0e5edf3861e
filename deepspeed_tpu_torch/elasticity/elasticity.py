"""Elastic training's batch algebra (the port of
``deepspeed_tpu/elasticity/elasticity.py``; DeepSpeed's
``elasticity/elasticity.py``, ``compute_elastic_config`` and the v0.1 / v0.2
compatible-world computations).

It picks ONE train batch size (at most ``max_train_batch_size``) that stays
constant while the job scales across the widest set of GPU counts, with a
micro-batch from the user's list at each count. v0.2 adds model
parallelism: only GPU counts that are multiples of ``model_parallel_size``
(and of whole nodes where a model-parallel group spans nodes) are usable,
and the data-parallel world is GPUs / mp. Host-only arithmetic.
"""

from __future__ import annotations

from ..runtime.config import ElasticityConfig

LATEST_ELASTICITY_VERSION = 0.2
MINIMUM_DEEPSPEED_VERSION = "0.3.8"


class ElasticityError(Exception):
    pass


class ElasticityConfigError(ElasticityError):
    pass


class ElasticityIncompatibleWorldSize(ElasticityError):
    pass


def get_valid_gpus(batch_size: int, micro_batches: list[int], min_gpus: int, max_gpus: int) -> list[int]:
    """GPU counts g for which some micro-batch m satisfies batch % (m*g)==0."""
    return [
        g
        for g in range(min_gpus, max_gpus + 1)
        if any(batch_size % (m * g) == 0 for m in micro_batches)
    ]


def _candidate_batch_sizes(micro_batches: list[int], max_batch: int) -> list[int]:
    """All feasible global batch sizes ≤ max_batch: multiples of each allowed
    micro-batch."""
    out = set()
    for m in micro_batches:
        out.update(range(m, max_batch + 1, m))
    return sorted(out, reverse=True)


def _best_batch(
    micro_batches: list[int],
    max_batch: int,
    min_gpus: int,
    max_gpus: int,
    prefer_larger: bool = True,
) -> tuple[int, list[int]]:
    """Batch size with the widest set of compatible GPU counts; ties broken
    toward the larger (or smaller) batch per ``prefer_larger``."""
    best_b, best_valid = 0, []
    for b in _candidate_batch_sizes(micro_batches, max_batch):
        valid = get_valid_gpus(b, micro_batches, min_gpus, max_gpus)
        if len(valid) > len(best_valid) or (
            len(valid) == len(best_valid) and prefer_larger and b > best_b
        ):
            best_b, best_valid = b, valid
    if not best_valid:
        raise ElasticityError(
            f"no batch size ≤ {max_batch} is compatible with any chip count in "
            f"[{min_gpus}, {max_gpus}] for micro-batches {micro_batches}"
        )
    return best_b, best_valid


def _get_compatible_gpus_v01(
    micro_batches, max_acceptable_batch_size, min_gpus=1, max_gpus=10000, prefer_larger=True
):
    """DeepSpeed elasticity.py:125."""
    return _best_batch(micro_batches, max_acceptable_batch_size, min_gpus, max_gpus, prefer_larger)


def _get_compatible_gpus_v02(
    micro_batches,
    max_acceptable_batch_size,
    current_num_gpus,
    min_gpus=1,
    max_gpus=10000,
    prefer_larger=True,
    num_gpus_per_node=1,
    model_parallel_size=1,
):
    """DeepSpeed elasticity.py:173: v0.2 adds model parallelism — only GPU
    counts that are multiples of ``model_parallel_size`` (and of whole nodes
    when MP spans nodes) are usable; the DP world is GPUs / mp."""
    if model_parallel_size > 1:
        group = (
            num_gpus_per_node * (model_parallel_size // num_gpus_per_node)
            if model_parallel_size > num_gpus_per_node
            else model_parallel_size
        )
        if current_num_gpus % group != 0:
            raise ElasticityIncompatibleWorldSize(
                f"world size {current_num_gpus} not divisible by model-parallel group {group}"
            )
        dp_max = max_gpus // model_parallel_size
        dp_min = max(1, min_gpus // model_parallel_size)
        batch, valid_dp = _best_batch(
            micro_batches, max_acceptable_batch_size, dp_min, dp_max, prefer_larger
        )
        return batch, [dp * model_parallel_size for dp in valid_dp]
    return _best_batch(micro_batches, max_acceptable_batch_size, min_gpus, max_gpus, prefer_larger)


def compute_elastic_config(
    ds_config: dict | ElasticityConfig,
    target_deepspeed_version: str = "latest",
    world_size: int = 0,
):
    """DeepSpeed elasticity.py:287. Returns ``(final_batch_size, valid_gpus)``;
    with a nonzero ``world_size`` it validates membership and returns
    ``(final_batch_size, valid_gpus, micro_batch)`` with the largest feasible
    micro-batch for that world (matching the reference's calling convention)."""
    if isinstance(ds_config, dict):
        from ..runtime.config import _build

        ecfg = _build(ElasticityConfig, ds_config.get("elasticity", ds_config))
    else:
        ecfg = ds_config
    if not ecfg.micro_batch_sizes:
        raise ElasticityConfigError("elasticity.micro_batch_sizes must be non-empty")
    if ecfg.max_train_batch_size < max(ecfg.micro_batch_sizes):
        raise ElasticityConfigError(
            f"max_train_batch_size {ecfg.max_train_batch_size} smaller than the "
            f"largest micro batch {max(ecfg.micro_batch_sizes)}"
        )

    mp = ecfg.model_parallel_size if ecfg.version >= 0.2 else 1
    if ecfg.version >= 0.2 and world_size:
        final_batch, valid_gpus = _get_compatible_gpus_v02(
            ecfg.micro_batch_sizes,
            ecfg.max_train_batch_size,
            world_size,
            ecfg.min_gpus,
            ecfg.max_gpus,
            ecfg.prefer_larger_batch,
            num_gpus_per_node=ecfg.num_gpus_per_node,
            model_parallel_size=mp,
        )
    else:
        final_batch, valid_gpus = _get_compatible_gpus_v01(
            ecfg.micro_batch_sizes,
            ecfg.max_train_batch_size,
            ecfg.min_gpus,
            ecfg.max_gpus,
            ecfg.prefer_larger_batch,
        )

    if world_size:
        if world_size not in valid_gpus:
            raise ElasticityIncompatibleWorldSize(
                f"world size {world_size} not in the elastic set {valid_gpus}"
            )
        # micro-batch divides the DP world (= GPUs / model-parallel size)
        dp = world_size // mp
        candidates = [m for m in ecfg.micro_batch_sizes if final_batch % (m * dp) == 0]
        if not candidates:
            raise ElasticityIncompatibleWorldSize(
                f"no micro-batch in {ecfg.micro_batch_sizes} realizes batch "
                f"{final_batch} at dp={dp} (world {world_size} / mp {mp})"
            )
        return final_batch, valid_gpus, max(candidates)
    return final_batch, valid_gpus
