"""Elastic-config inspector (``bin/dstpu_elastic``'s counterpart; DeepSpeed's
``bin/ds_elastic``):

    python -m deepspeed_tpu_torch.elasticity -c ds_config.json        # compatible world sizes
    python -m deepspeed_tpu_torch.elasticity -c ds_config.json -w 16  # validate one world

Its output and exit codes are ``bin/dstpu_elastic``'s:

    0  the config is valid (and the requested world size, if given, is
       compatible)
    2  a usage error: bad arguments, a missing or unparseable config file,
       or a malformed elasticity block
    3  the elastic config REJECTS the requested world size (the config is
       well-formed; this world is not in the compatible set)
"""

import argparse
import json
import sys

from .elasticity import ElasticityError, ElasticityIncompatibleWorldSize, compute_elastic_config

EXIT_OK = 0
EXIT_USAGE = 2
EXIT_INCOMPATIBLE_WORLD = 3


def main(argv=None):
    p = argparse.ArgumentParser(description="DeepSpeed-TPU elastic config tool")
    p.add_argument("-c", "--config", required=True, help="DeepSpeed config json")
    p.add_argument("-w", "--world-size", type=int, default=0,
                   help="validate this GPU count and show its micro-batch")
    args = p.parse_args(argv)
    try:
        with open(args.config) as f:
            ds_config = json.load(f)
    except (OSError, ValueError) as e:
        print(f"dstpu_elastic: cannot read config {args.config}: {e}",
              file=sys.stderr)
        return EXIT_USAGE
    try:
        if args.world_size:
            final_batch, valid, micro = compute_elastic_config(
                ds_config, world_size=args.world_size)
            print(f"world size {args.world_size}: train_batch_size={final_batch}, "
                  f"micro_batch_per_chip={micro}")
        else:
            final_batch, valid = compute_elastic_config(ds_config)
            print(f"train_batch_size={final_batch}")
            print(f"compatible chip counts: {sorted(valid)}")
    except ElasticityIncompatibleWorldSize as e:
        print(f"dstpu_elastic: {e}", file=sys.stderr)
        return EXIT_INCOMPATIBLE_WORLD
    except ElasticityError as e:  # malformed/infeasible elasticity block
        print(f"dstpu_elastic: bad elasticity config: {e}", file=sys.stderr)
        return EXIT_USAGE
    except (TypeError, KeyError, AttributeError, ValueError) as e:
        # a structurally wrong config (JSON array, non-list
        # micro_batch_sizes, ...) fails inside the algebra with a raw
        # builtin error — still a usage error, never a traceback
        print(f"dstpu_elastic: malformed config {args.config}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return EXIT_USAGE
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
