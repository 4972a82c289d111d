"""Weights made on the device from the seed, in a few large calls.

The program hands over only the layout of its parameter tree (paths,
shapes and dtypes, from its ``init`` on the ``meta`` device). Leaves of
one dtype are views into one flat buffer, each at an offset aligned to
128 elements. The buffer is filled chunk by chunk: a float32 normal draw
from a generator seeded by (seed, dtype, chunk), turned into each leaf's
values by the leaf's rule, then cast into the buffer. So the values
depend only on the seed, the layout and the device, and any chunk can be
drawn again alone: :func:`init_distance` measures how far trained leaves
have moved from their start without a second copy of the weights.

The rules (by the leaf's name; fan-in is the input axes of the unstacked
leaf):

- matrices: normal / sqrt(fan-in); the attention output ``wo`` (H, Dh,
  d) takes H * Dh as its fan-in, an expert stack (E, d, f) its d;
- ``tok``: normal / sqrt(d_model);
- RMS gains (``gamma``, the gated norm's ``norm``, ``ln_x``): 0.1 x
  normal around the program's zero centre (it scales by 1 + gamma);
- biases (``bq``, ``bk``, ``bv``, ``conv_b``): 0.02 x normal;
- Mamba-2: ``A_log`` = log(A), A uniform in [1, 16]; ``dt_bias`` the
  inverse softplus of dt, log-uniform in [1e-3, 1e-1] (the published
  initialisation); ``D`` = 1 + 0.1 x normal; ``conv_w`` 0.5 x normal;
- any other vector: 0.5 x normal.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch

CHUNK = 1 << 27                 # elements drawn per call
ALIGN = 128                     # elements
STACK_AXES = {"layers": 1, "tail": 1, "dense_layers": 1, "enc_layers": 1,
              "blocks": 2}
GAINS = ("gamma", "norm", "ln_x")
BIASES = ("bq", "bk", "bv", "conv_b")

Spec = List[Tuple[str, Tuple[int, ...], torch.dtype]]


def derive(seed: int, *parts) -> int:
    """A 63-bit seed from ``seed`` and ``parts``."""
    h = hashlib.sha256(repr((int(seed),) + tuple(parts)).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def spec_of(leaves: Iterable[Tuple[str, torch.Tensor]]) -> Spec:
    """(path, shape, dtype) of each leaf of a tree given as path pairs."""
    return [(p, tuple(t.shape), t.dtype) for p, t in leaves]


def _rule(path: str, shape: Tuple[int, ...]) -> Callable[[torch.Tensor],
                                                          torch.Tensor]:
    parts = path.split("/")
    name = parts[-1]
    own = shape[STACK_AXES.get(parts[0], 0):]
    if name == "tok":
        s = 1.0 / math.sqrt(own[1])
        return lambda z: z * s
    if name in GAINS:
        return lambda z: z * 0.1
    if name in BIASES:
        return lambda z: z * 0.02
    if name == "A_log":
        return lambda z: torch.log1p(15.0 * _uniform(z))
    if name == "dt_bias":
        lo, hi = math.log(1e-3), math.log(1e-1)

        def dt_bias(z):
            dt = torch.exp(lo + (hi - lo) * _uniform(z))
            return dt + torch.log(-torch.expm1(-dt))     # softplus^-1
        return dt_bias
    if name == "D":
        return lambda z: 1.0 + 0.1 * z
    if name == "conv_w":
        return lambda z: z * 0.5
    if len(own) == 1:
        return lambda z: z * 0.5
    if name == "wo" and len(parts) > 1 and parts[-2] in ("attn", "xattn"):
        fan_in = own[0] * own[1]
    elif len(parts) > 1 and parts[-2] == "moe" and len(own) == 3:
        fan_in = own[1]
    else:
        fan_in = own[0]
    s = 1.0 / math.sqrt(fan_in)
    return lambda z: z * s


def _uniform(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(z * (0.5 ** 0.5)))


class Layout:
    """Where each leaf lives: per dtype one flat buffer, and per leaf its
    (dtype, offset, numel, shape)."""

    def __init__(self, spec: Spec):
        self.spec = list(spec)
        self.sizes: Dict[torch.dtype, int] = {}
        self.where: Dict[str, Tuple[torch.dtype, int, int, Tuple]] = {}
        for path, shape, dtype in self.spec:
            off = self.sizes.get(dtype, 0)
            n = math.prod(shape)
            self.where[path] = (dtype, off, n, shape)
            self.sizes[dtype] = off + -(-n // ALIGN) * ALIGN

    def leaves_of(self, dtype: torch.dtype):
        return [(p, *self.where[p][1:]) for p, _, dt in self.spec
                if dt == dtype]


def _chunks(total: int):
    for k, lo in enumerate(range(0, total, CHUNK)):
        yield k, lo, min(total, lo + CHUNK)


def _draw(seed: int, dtype: torch.dtype, k: int, n: int,
          device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "weights", str(dtype), k))
    z = torch.empty(n, dtype=torch.float32, device=device)
    return z.normal_(generator=gen)


def _segments(layout: Layout, dtype, lo: int, hi: int):
    """(path, slice in the buffer, slice in the chunk, the leaf's shape)
    of each leaf overlapping [lo, hi)."""
    for path, off, n, shape in layout.leaves_of(dtype):
        a, b = max(lo, off), min(hi, off + n)
        if a < b:
            yield path, slice(a, b), slice(a - lo, b - lo), shape


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The leaves of ``spec`` (path -> tensor), made from ``seed``."""
    device = torch.device(device)
    layout = Layout(spec)
    out: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for dtype, total in layout.sizes.items():
            buf = torch.empty(total, dtype=dtype, device=device)
            for k, lo, hi in _chunks(total):
                z = _draw(seed, dtype, k, hi - lo, device)
                for path, dst, src, shape in _segments(layout, dtype, lo, hi):
                    buf[dst].copy_(_rule(path, shape)(z[src]))
                del z
            for path, off, n, shape in layout.leaves_of(dtype):
                out[path] = buf[off:off + n].view(shape)
    return out


def init_distance(leaves: Dict[str, torch.Tensor], spec: Spec, seed: int
                  ) -> Dict[str, float]:
    """Per leaf, the L2 norm of (leaf - its value as :func:`make` made it
    from ``seed``), drawing one chunk at a time. ``leaves``: path ->
    tensor of the spec's shape (those :func:`make` returned, changed in
    place, or a gathered copy)."""
    layout = Layout(spec)
    sq: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for dtype, total in layout.sizes.items():
            flat = {p: leaves[p].reshape(-1) for p, *_ in
                    layout.leaves_of(dtype)}
            device = next(iter(flat.values())).device
            for k, lo, hi in _chunks(total):
                z = _draw(seed, dtype, k, hi - lo, device)
                for path, dst, src, shape in _segments(layout, dtype, lo, hi):
                    off = layout.where[path][1]
                    cur = flat[path][dst.start - off:dst.stop - off].float()
                    init = _rule(path, shape)(z[src]).to(dtype).float()
                    d = torch.linalg.vector_norm(cur - init) ** 2
                    sq[path] = sq[path] + d if path in sq else d
                del z
    return {p: math.sqrt(float(v)) for p, v in sq.items()}


def nest(flat: Dict[str, torch.Tensor]) -> Dict:
    """path -> tensor pairs as a nested dict."""
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = t
    return tree


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A nested dict of tensors as path -> tensor pairs, in key order."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out
