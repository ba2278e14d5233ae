"""chip_smoke.py's T7 alone on one GPU, after the kernels' build, then
MO-RDF-PN-S0's train -> fold -> serve repeated on fresh EMAs: each
repeat logs the bf16 deploy form's error against float32 plain beside
its bf16 spread, and the float32 deploy form on the card against the
CPU.  The card's backward is not deterministic, so each repeat's EMA
differs.

  python3 tools/chip_t7.py [REPEATS]      # from the root of the repo
"""
import os
import sys

sys.path.insert(0, os.getcwd())
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main(repeats=4):
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.kernels import build
    cs.log(cs.device_line())
    dev = torch.device("cuda", 0)
    cs.log(f"build: {build.build():.2f} s")
    with cs.phase("T7 training the reparameterizable configurations"):
        counts = cs.train_reparameterizable(dev)
    cs.log(f"T7 launches {counts}")
    label, fields, want, _ = cs.T7_PATHS[1]
    for i in range(repeats):
        with cs.phase(f"repeat {i} {label}"):
            cfg = AchelousConfig(resolution=cs.TRAIN_RES,
                                 dtype=torch.bfloat16, **fields)
            ema = {}
            cs.train_path(dev, f"R{i}", label, cfg, want, cs.T6_STEPS,
                          ema=ema)
            cs.deploy_against_train(dev, f"R{i} {label} trained EMA", cfg,
                                    ema, cpu_tol=cs.FLOAT32_PATH_TOL)
            cs.serve_trained(dev, label, fields, want, ema, False)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
