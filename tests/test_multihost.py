"""Multi-host launch path (VERDICT round-1 item 8; SURVEY.md section 2.15
item 5): N=2 separate processes, each with 2 virtual CPU devices, joined
by jax.distributed into one 4-device mesh. The merged multi-host render
must match the plain single-process render."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_render_matches_single(tmp_path):
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "multihost_worker.py")
    out = str(tmp_path / "mh.npz")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)   # worker pins cpu itself
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, "2", str(i), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    outs = [p.communicate(timeout=850)[0] for p in procs]
    from prt.utils.jax_cache import cpu_cache_dir
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, o.decode()[-3000:]
        # Each worker keeps its compile cache in its own host-keyed
        # sub-directory of the checkout's (or JAX_COMPILATION_CACHE_DIR's).
        assert f"cache_dir {cpu_cache_dir(f'multihost_{i}')}\n" in o.decode()
    z = np.load(out)

    # Single-process reference of the same scene.
    from tests.multihost_worker import SCENE
    from prt.scene.parser import load_scene_string
    from prt import render as R
    scene, opts = load_scene_string(SCENE)
    rgb_ref, alpha_ref = R.render(scene, opts)

    np.testing.assert_allclose(z["rgb"], rgb_ref, atol=1e-5)
    np.testing.assert_allclose(z["alpha"], alpha_ref, atol=1e-5)
