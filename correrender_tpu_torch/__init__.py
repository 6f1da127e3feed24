"""correrender_tpu_torch — the PyTorch/CUDA port of ``correrender_tpu``.

The JAX package ``correrender_tpu`` is the reference; this package keeps
its module paths, function names and array layouts (a member stack is
``(Z, Y, X, n)``, a field ``(Z, Y, X)``, an image ``(H, W, 4)`` with
straight alpha), and never imports JAX.

Device policy. Data lives where the caller puts it: functions take
tensors, or an explicit ``device`` where they create them, and random
draws take an explicit ``torch.Generator``. Every kernel wrapper
(``ops/cuda``) dispatches on the device of the tensor it is given: a CPU
tensor runs the kernel's plain PyTorch version, a CUDA tensor launches
the hand-written sm_90a kernel or raises. There is no fallback from the
kernel to the plain version and no switch that selects between them.
"""

__version__ = "0.1.0"
