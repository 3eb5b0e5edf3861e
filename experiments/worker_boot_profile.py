"""Where a serving worker's boot goes on the card: the stages of
``launcher/serving_worker.py``'s boot, each timed on the host clock from
the interpreter's first line (a GPT-2-125M bf16 engine, phase 20's serving
config), and the elastic training worker's first two train_batch calls.

    python experiments/worker_boot_profile.py [--import-only]

Prints one JSON line of seconds per stage, beside whether this interpreter
writes bytecode (``sys.dont_write_bytecode``, ``sys.pycache_prefix``) and
whether torch's package directory holds any. ``--import-only`` stops after
``import torch``: run it twice with ``PYTHONPYCACHEPREFIX`` set (and
``PYTHONDONTWRITEBYTECODE`` unset) to see what cached bytecode saves.
"""

import time

T0 = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    marks = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - T0, 3)

    import numpy as np
    import torch
    mark("import_torch")
    bytecode = {"dont_write_bytecode": sys.dont_write_bytecode, "pycache_prefix": sys.pycache_prefix,
                "torch_has_pycache": os.path.isdir(os.path.join(os.path.dirname(torch.__file__), "__pycache__"))}
    if "--import-only" in sys.argv:
        print(json.dumps({"boot_stages_s": marks, "bytecode": bytecode}))
        return 0
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    mark("cuda_context")
    x = torch.randn(1024, 1024, device="cuda", dtype=torch.bfloat16)
    float((x @ x).float().sum())
    mark("first_matmul")
    import chip_smoke as c
    from deepspeed_tpu_torch.launcher.serving_worker import build_serving_engine
    from deepspeed_tpu_torch.ops import op_builder
    mark("import_package")
    op_builder.load("decode_attention")
    mark("load_decode_kernel")
    spec, _, _ = c.fleet_worker_plan(c.SERVE_CONFIG)
    eng = build_serving_engine(spec, device="cuda")
    torch.cuda.synchronize()
    mark("build_engine")
    eng.engine.generate(np.zeros((1, 8), np.int32), max_new_tokens=2)
    mark("first_generate")
    eng.warm_decode()
    torch.cuda.synchronize()
    mark("warm_decode")
    eng.close()
    del eng

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.transformer import Model
    cfg, ds = c.elastic_model("gpt2")
    trainer = deepspeed_tpu_torch.initialize(model=Model(cfg), config=ds)[0]
    torch.cuda.synchronize()
    mark("train_initialize")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(trainer.train_batch_size,
                                                                        cfg.max_seq_len + 1)).astype(np.int32)
    for i in range(2):
        float(trainer.train_batch({"tokens": tokens})["loss"])
        mark(f"train_batch_{i + 1}")
    print(json.dumps({"boot_stages_s": marks, "bytecode": bytecode, "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
