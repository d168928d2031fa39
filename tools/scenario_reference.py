#!/usr/bin/env python3
"""Write the reference's initial parameters for the streaming scenarios.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/scenario_reference.py

Run it from the root of a checkout, on the CPU.  The reference's
``repro.fed.scenarios.build_scheduler`` starts every scenario from
``init_small(jax.random.PRNGKey(sc.seed), SYNTHETIC_LR)``.  The port runs
with no JAX and cannot redraw jax's normal bit for bit, so this script
writes those parameters for seeds 0..SEEDS-1 into
``src/repro_torch/fed/scenario_init.npz``, in the reference's layout (keys
``seed<s>/<leaf>``), with the command, the jax and numpy versions and the
backend under the key ``about`` (a JSON string).  The port's
``repro_torch.fed.scenarios.build_scheduler`` reads the file and refuses a
seed it does not hold; ``tests/test_torch_scenarios.py`` recomputes every
committed seed and compares.  Rerun it only if ``src/repro/models/small.py``
or ``src/repro/configs/paper.py`` change, or to commit more seeds.
"""
from __future__ import annotations

import json
import platform
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.paper import SYNTHETIC_LR  # noqa: E402
from repro.models.small import init_small  # noqa: E402

OUT = ROOT / "src" / "repro_torch" / "fed" / "scenario_init.npz"
COMMAND = "JAX_PLATFORMS=cpu PYTHONPATH=src python tools/scenario_reference.py"
SEEDS = 16


def main() -> None:
    arrays = {}
    for seed in range(SEEDS):
        for name, leaf in init_small(jax.random.PRNGKey(seed),
                                     SYNTHETIC_LR).items():
            arrays[f"seed{seed}/{name}"] = np.asarray(leaf)
    about = {"command": COMMAND, "jax": jax.__version__,
             "numpy": np.__version__, "python": platform.python_version(),
             "backend": jax.default_backend(), "config": SYNTHETIC_LR.name,
             "seeds": list(range(SEEDS))}
    np.savez(OUT, about=np.asarray(json.dumps(about)), **arrays)
    print(f"wrote {OUT.relative_to(ROOT)}: seeds 0..{SEEDS - 1}, "
          f"{len(arrays)} arrays, {OUT.stat().st_size} bytes")


if __name__ == "__main__":
    main()
