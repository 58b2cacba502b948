"""Explicit build entry point for the native host kernels (counterpart of
``terrain_diffusion_tpu.native.build``).

    python -m terrain_diffusion_tpu_torch.native.build [--force]

Compiles ``src/{portable_rng,perlin}.cpp`` with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``terrain_diffusion_tpu_torch/_build/libterrain_native.so``
and prints its path.  Importing ``terrain_diffusion_tpu_torch.native`` never compiles;
it only loads the library this command produced.
"""
import sys

from terrain_diffusion_tpu_torch import native


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    force = "--force" in argv
    try:
        path = native.build(force=force)
    except RuntimeError as e:
        print(f"native build failed: {e}", file=sys.stderr)
        return 1
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
