"""Worker process for the multi-host CPU test: initializes
jax.distributed against a local coordinator, renders the shared tiny
scene over the global mesh, and (process 0) saves the result."""
import os
import sys


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    coordinator, nproc, pid, out_path = sys.argv[1:5]
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from prt.utils.jax_cache import cpu_cache_dir
    jax.config.update("jax_compilation_cache_dir",
                      cpu_cache_dir(f"multihost_{pid}"))
    print("cache_dir", jax.config.jax_compilation_cache_dir, flush=True)

    # Initialize BEFORE importing prt's modules: they build module-level
    # jnp constants on import, which would initialize the XLA backend.
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=int(nproc),
                               process_id=int(pid))
    from prt.parallel import multihost
    assert jax.process_count() == int(nproc)
    assert len(jax.devices()) == 2 * int(nproc)

    from prt.scene.parser import load_scene_string
    scene, opts = load_scene_string(SCENE)
    rgb, alpha = multihost.render_multihost(scene, opts)

    if jax.process_index() == 0:
        import numpy as np
        np.savez(out_path, rgb=rgb, alpha=alpha)
    jax.distributed.shutdown()


SCENE = """
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Camera "perspective" "float fov" [60]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
SurfaceIntegrator "whitted"
WorldBegin
LightSource "point" "point from" [1 2 -2] "color I" [12 12 12]
Material "matte" "color Kd" [0.7 0.3 0.2]
Translate 0 0 3
Shape "sphere" "float radius" [1]
WorldEnd
"""


if __name__ == "__main__":
    main()
