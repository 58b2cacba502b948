"""Plain PyTorch reference of the 90 m world, for the benchmark's `correct`.

A frozen, import-free copy of the plain paths of the port: the
magnitude-preserving U-Net (``unet.py``), the threefry noise field
(``noise.py``), the synthetic conditioning map (``synthetic_map.py``), the
DPM-Solver++ sampler (``sampler.py``), the image and Laplacian operations of
output composition (``image.py``), the window arithmetic (``window.py``) and
a direct, unbatched evaluator of the three stages and the composition
(``world.py``).

It imports neither JAX nor either terrain package.  It takes only what the
benchmark hands to both sides (the weights, the world seed and the requested
tiles) and works out again everything the program derives from them: the
conditioning map, the noise, the window geometry and the blending.  Every
convolution and matmul can round its operands through a function given to
the models (``unet.QUANTIZERS``), which makes the lower-precision control.
"""
