"""Runs the JAX package on a 4-device host mesh for the port's mesh tests.

XLA fixes its device count when JAX first initialises, and the test
process's JAX has one CPU device.  So each mesh test file runs the
reference once, in one subprocess that sets
``--xla_force_host_platform_device_count=4`` before ``import jax`` (as
``tests/test_packed_sharded.py`` does): ``run(script, inputs, tmp)``
writes ``inputs`` (numpy arrays) to an ``.npz``, runs ``script`` with
``inp`` (those arrays) and ``save(**arrays)`` in scope, and returns what
it saved.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

import torch_threads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
assert jax.device_count() == 4, jax.devices()
_SRC, _DST = sys.argv[1], sys.argv[2]
inp = dict(np.load(_SRC))
_out = {}
def save(**arrays):
    _out.update({k: np.asarray(v) for k, v in arrays.items()})
"""

EPILOGUE = """
np.savez(_DST, **_out)
"""


def run(script: str, inputs: dict, tmp) -> dict:
    """``script`` on a 4-device JAX mesh in a subprocess; its saved
    arrays."""
    src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
    np.savez(src, **inputs)
    env = torch_threads.subprocess_env()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH", ""))
        if p)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", PRELUDE + script + EPILOGUE,
                        src, dst], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(dst))
