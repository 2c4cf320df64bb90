#!/usr/bin/env python
"""Command-line renderer: parse a .pbrt scene, render, write the EXR.

The front end matching the reference's main()
(/root/reference/renderer/pbrt.cpp:28-51): pbrtInit -> ParseFile ->
pbrtCleanup becomes parse -> render (with progress bar) -> write_exr,
followed by the stats table (printed at WorldEnd in the reference,
core/api.cpp:479).

Usage: python pbrt.py scene.pbrt [-o out.exr] [--integrator NAME]
       [--spp N] [--resume] [--quiet]
"""
import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("scene", help=".pbrt scene file")
    ap.add_argument("-o", "--outfile", default=None,
                    help="output EXR (default: scene's Film filename)")
    ap.add_argument("--integrator", default=None,
                    help="override the scene's surface integrator")
    ap.add_argument("--spp", type=int, default=None,
                    help="override samples per pixel")
    ap.add_argument("--resume", action="store_true",
                    help="resume from <outfile>.ckpt.npz if present")
    ap.add_argument("--checkpoint", action="store_true",
                    help="write a resume checkpoint at each writefrequency")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress progress bar and stats table")
    args = ap.parse_args(argv)

    from prt.utils.jax_cache import enable_compile_cache
    enable_compile_cache()
    from prt.scene.parser import load_scene
    from prt import render as R
    from prt.io import exr
    from prt.utils.stats import StatsRegistry

    scene, opts = load_scene(args.scene)
    # The EXR writer stores HALF pixels (reference core/exrio.cpp), so the
    # CLI reads the film back at transport-matching f16 precision.
    opts = opts._replace(half_readback=True)
    if args.outfile:
        opts = opts._replace(filename=args.outfile)
    if args.integrator:
        opts = opts._replace(integrator=args.integrator)
    if args.spp:
        # Override only the sample count; the scene's sampler kind (and its
        # sequence) stays as authored. Stratified samplers express spp as
        # xsamples*ysamples — factor the override into a near-square grid.
        if opts.sampler.kind == "stratified":
            xs = max(1, int(args.spp ** 0.5))
            ys = max(1, (args.spp + xs - 1) // xs)
            opts = opts._replace(
                sampler=opts.sampler._replace(xsamples=xs, ysamples=ys))
        else:
            opts = opts._replace(
                sampler=opts.sampler._replace(pixelsamples=args.spp))

    ckpt = opts.filename + ".ckpt.npz" if (args.checkpoint or args.resume) \
        else None
    stats = StatsRegistry()
    rgb, alpha = R.render(scene, opts, progress=not args.quiet, stats=stats,
                          checkpoint_path=ckpt, resume=args.resume)
    exr.write_exr(opts.filename, rgb, alpha)
    if not args.quiet:
        stats.print()
        print(f"Wrote {opts.filename}")
    if ckpt and os.path.exists(ckpt):
        os.remove(ckpt)  # render completed; the checkpoint is stale
    return 0


if __name__ == "__main__":
    sys.exit(main())
