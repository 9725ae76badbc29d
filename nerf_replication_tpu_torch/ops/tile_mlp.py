"""What the two MLPs on the tile core (csrc/nerf_mlp_tile.cuh,
csrc/mlp_bwd_tile.cuh) share: the canonical NeRF MLP of #1/#3/#5
(``mlp_kernel``, ``mlp_train``) and D-NeRF's deformation MLP Psi_t
(``deform_mlp``).

* A network's pack is data, a :class:`Layout`: the members of its weight
  and bias packs (:class:`Member`: each a block of one ``nn.Linear``
  parameter, transposed to (in, out) and zero-padded, with the K-slabs in
  which each image stages it) and the planes of its backward's
  workspace. ``mlp_kernel.layout`` and ``deform_mlp.layout`` give the
  two.
* :func:`pack_index`: the packs as two gathers from the parameters'
  concatenation, and the inverse gather by which a backward maps the
  packs' gradients back (:func:`param_grads`). :func:`gather` makes the
  packs, differentiably; :func:`pack` a :class:`Pack` for the kernels,
  and :func:`packer` the same once a parameter version.
* :func:`image_index`: the permutations from a pack to the images the
  kernels read.
* :func:`unpack`: a pack's matrices and biases by name, for the plain
  versions.
* The backward's workspace: the point padding, the tile-order planes, the
  partial sums and the group of the two-pass reduction
  (:func:`backward_workspace`, :func:`workspace_planes`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

PAD = 128          # the delta kernel takes whole 128-point tiles
BIAS_ROWS = 64     # points per bias partial (one of a tile's two warpgroups)
CHUNK = 4096       # points per partial of the weight-gradient kernel
GROUP = 64         # points per group of a tile-order workspace plane
SLAB_K = 64        # weight rows per shared-memory stage of the kernels


@dataclasses.dataclass(frozen=True)
class Member:
    """One matrix of a weight pack, or one vector of a bias pack (``cols``
    1): ``rows`` x ``cols``, row-major (in, out). Its first ``keep_rows``
    rows and ``keep_cols`` columns are the transpose of the columns
    ``col0 ..`` of the parameter ``param`` (an ``nn.Linear`` weight, (out,
    in); a bias reads as one row); the rest is zero. ``slab`` and
    ``slab_t``: the rows of a K-slab in which the forward image stages the
    matrix and the transposed image its transpose; 0 where that image
    keeps it as in the pack."""

    name: str
    rows: int
    cols: int
    param: str
    col0: int
    keep_rows: int
    keep_cols: int
    slab: int
    slab_t: int


def matrix(name: str, rows: int, cols: int, param: str, col0: int = 0,
           keep: tuple | None = None, slab: int | None = None,
           slab_t: int | None = None) -> Member:
    """A weight member, by default all kept and staged in K-slabs of at
    most SLAB_K rows by both images."""
    keep_rows, keep_cols = keep or (rows, cols)
    return Member(name, rows, cols, param, col0, keep_rows, keep_cols,
                  min(rows, SLAB_K) if slab is None else slab,
                  min(cols, SLAB_K) if slab_t is None else slab_t)


def vector(name: str, size: int, param: str,
           keep: int | None = None) -> Member:
    """A bias member: ``size`` elements, the first ``keep`` (all) of them
    the bias ``param``."""
    return Member(name, size, 1, param, 0, keep or size, 1, 0, 0)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A network's pack for the kernels. ``weights`` and ``biases``: the
    members of the weight and the bias pack, in pack order. ``act`` and
    ``dlt``: (plane, columns) of the backward's activation and delta
    workspaces, in order; ``h`` and ``d`` are a plane a trunk layer, and a
    plane named None is one no check reads. ``depth`` and ``skip``: the
    trunk's, as the kernels take them."""

    depth: int
    skip: int
    weights: tuple
    biases: tuple
    act: tuple
    dlt: tuple


@functools.cache
def parameters(layout: Layout) -> tuple:
    """(name, shape) of the parameters the members take, in the order
    their concatenation takes them (the weight pack's, then the bias
    pack's, each at its first member): an ``nn.Linear`` weight (out, in)
    as large as its members reach, a bias as long as its member keeps."""
    shapes = {}
    for m in layout.weights:
        out, fan_in = shapes.get(m.param, (0, 0))
        shapes[m.param] = (max(out, m.keep_cols),
                           max(fan_in, m.col0 + m.keep_rows))
    for m in layout.biases:
        shapes[m.param] = (m.keep_rows,)
    return tuple(shapes.items())


@functools.cache
def pack_index(layout: Layout, device=torch.device("cpu")):
    """(w_index, b_index, inverse, zero) on ``device``: each element of the
    weight and bias packs as a position in the concatenation of the
    flattened parameters with ``zero`` (one 0) appended, whose position
    (the last) every padding element takes; and each parameter element's
    position in the packs' concatenation (every one has exactly one), the
    gather that maps the packs' gradients back."""
    start, shapes, at = {}, dict(parameters(layout)), 0
    for name, shape in parameters(layout):
        start[name] = at
        at += math.prod(shape)

    def index(members):
        parts = []
        for m in members:
            idx = torch.full((m.rows, m.cols), at, dtype=torch.int64)
            k = torch.arange(m.keep_rows)[:, None]
            n = torch.arange(m.keep_cols)[None, :]
            idx[:m.keep_rows, :m.keep_cols] = (
                start[m.param] + n * shapes[m.param][-1] + m.col0 + k)
            parts.append(idx.reshape(-1))
        return torch.cat(parts)

    w_index, b_index = index(layout.weights), index(layout.biases)
    inverse = torch.full((at + 1,), -1, dtype=torch.int64)
    inverse[b_index] = w_index.numel() + torch.arange(b_index.numel())
    inverse[w_index] = torch.arange(w_index.numel())
    return (w_index.to(device), b_index.to(device), inverse[:at].to(device),
            torch.zeros(1, device=device))


def params_of(layout: Layout, named: dict) -> list:
    """``layout``'s parameters (:func:`parameters`) from ``named`` (a state
    dict, or a module's named parameters), in order. Raises where
    ``named`` holds another parameter or another shape: a network the pack
    does not cover."""
    shapes = parameters(layout)
    extra = set(named) - {name for name, _ in shapes}
    if extra:
        raise ValueError(f"tile-core pack: no place for {sorted(extra)}")
    params = []
    for name, shape in shapes:
        q = named.get(name)
        if q is None or tuple(q.shape) != shape:
            raise ValueError(f"tile-core pack: {name} is "
                             f"{None if q is None else tuple(q.shape)}, "
                             f"expected {shape}")
        params.append(q)
    return params


def gather(layout: Layout, params) -> tuple:
    """The (weight pack, bias pack) of ``params`` (:func:`params_of`), in
    their dtype: one concatenation and two gathers (:func:`pack_index`),
    differentiable with respect to the parameters."""
    w_index, b_index, _, zero = pack_index(layout, params[0].device)
    flat = torch.cat([q.reshape(-1) for q in params] + [zero])
    return flat[w_index], flat[b_index]


def param_grads(grad_w: torch.Tensor, grad_b: torch.Tensor,
                inverse: torch.Tensor, shapes) -> tuple:
    """The packs' gradients mapped back to parameters of ``shapes`` by
    ``inverse`` (:func:`pack_index`)."""
    flat = torch.cat([grad_w, grad_b])[inverse]
    return tuple(q.view(s) for q, s in
                 zip(flat.split([math.prod(s) for s in shapes]), shapes))


def _slab_order(at: torch.Tensor, slab_k: int) -> torch.Tensor:
    """``at`` (K, N) holds the pack index of each element of a matrix. The
    indices in the order the kernels stage that matrix: K-slabs of
    ``slab_k`` rows, each as 8 x 8 core matrices ``[k / 8][n / 8][n % 8]
    [k % 8]`` (the unswizzled K-major operand layout of wgmma)."""
    k, n = at.shape
    return at.reshape(k // slab_k, slab_k // 8, 8, n // 8, 8) \
        .permute(0, 1, 3, 4, 2).reshape(-1)


@functools.cache
def image_index(layout: Layout, transposed: bool,
                device=torch.device("cpu")) -> torch.Tensor:
    """The permutation ``perm`` (int64) with ``image = pack[perm]``: the
    forward image of the weight pack, or the transposed one the backward's
    delta products read (csrc/nerf_mlp_tile.cuh). Every matrix keeps its
    offset and is staged in its K-slabs (:class:`Member`)."""
    parts, at = [], 0
    for m in layout.weights:
        idx = torch.arange(at, at + m.rows * m.cols).view(m.rows, m.cols)
        at += m.rows * m.cols
        slab = m.slab_t if transposed else m.slab
        if slab:
            idx = _slab_order(idx.t() if transposed else idx, slab)
        parts.append(idx.reshape(-1))
    return torch.cat(parts).to(device)


@dataclasses.dataclass(frozen=True)
class Pack:
    """A network's weights in ``layout``'s packs: ``w`` the flat weight
    pack (bf16 for the kernels), ``b`` the flat f32 bias pack. ``img`` and
    ``img_t`` are the images of ``w`` the kernels read, made at first
    use."""

    w: torch.Tensor
    b: torch.Tensor
    layout: Layout

    @property
    def depth(self) -> int:
        return self.layout.depth

    @property
    def skip(self) -> int:
        return self.layout.skip

    @functools.cached_property
    def img(self) -> torch.Tensor:
        return self.w[image_index(self.layout, False, self.w.device)]

    @functools.cached_property
    def img_t(self) -> torch.Tensor:
        return self.w[image_index(self.layout, True, self.w.device)]


def _pack(layout: Layout, params) -> Pack:
    with torch.no_grad():
        w, b = gather(layout, params)
    return Pack(w.to(torch.bfloat16), b, layout)


def pack(layout: Layout, named: dict) -> Pack:
    """The kernels' pack of the parameters in ``named``
    (:func:`params_of`): bf16 weights and the biases in their dtype,
    detached."""
    return _pack(layout, params_of(layout, named))


def packer(layout: Layout):
    """A function ``named`` -> (:class:`Pack`, its ``inverse``
    (:func:`pack_index`), the parameters in order) that makes the pack
    from the parameters as they are at a call, and again only when one has
    changed (its storage or its version: the optimizer's step, a loaded
    state), so that the passes of a training step share it."""
    made = {}

    def pack_of(named: dict):
        params = params_of(layout, named)
        key = tuple((q.data_ptr(), q._version) for q in params)
        if made.get("key") != key:
            made.update(key=key, pack=_pack(layout, params))
        inverse = pack_index(layout, params[0].device)[2]
        return made["pack"], inverse, params

    return pack_of


def check_pack(packed: Pack, device: torch.device) -> None:
    """Raise unless ``packed`` is a contiguous bf16 weight and f32 bias
    pack on ``device``."""
    for t in (packed.w, packed.b):
        if t.device != device or not t.is_contiguous():
            raise ValueError("tile-core pack: the packs must be contiguous "
                             f"on {device}")
    if packed.w.dtype != torch.bfloat16 or packed.b.dtype != torch.float32:
        raise ValueError("tile-core pack: the packs must be bf16 weights "
                         "and f32 biases")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and back: the cast the kernels apply before a
    matmul."""
    return x.to(torch.bfloat16).float()


def _round_delta(d: torch.Tensor) -> torch.Tensor:
    """The bf16 rounding of a delta before a product."""
    return _bf16(d)


def _take(flat: torch.Tensor, at: int, rows: int, cols: int):
    return flat[at:at + rows * cols].view(rows, cols).float(), at + rows * cols


def unpack(packed: Pack) -> tuple:
    """The pack's matrices (f32, (in, out)) and biases (in the matrices'
    dtype) by their members' names."""
    w, at = {}, 0
    for m in packed.layout.weights:
        w[m.name], at = _take(packed.w, at, m.rows, m.cols)
    dt = w[packed.layout.weights[0].name].dtype
    b, at = {}, 0
    for m in packed.layout.biases:
        b[m.name] = packed.b[at:at + m.rows].to(dt)
        at += m.rows
    return w, b


def two_pass_group(rows: int) -> int:
    """Rows summed per group in the first of the two reduction passes."""
    return max(1, math.ceil(math.sqrt(rows)))


def padded(n: int) -> int:
    """``n`` points padded to whole tiles of the delta kernel."""
    return -(-n // PAD) * PAD


def workspace_columns(layout: Layout) -> tuple:
    """The column counts of the activation and the delta workspace's
    planes, in order (``layout.act``, ``layout.dlt``)."""
    return (tuple(cols for _, cols in layout.act),
            tuple(cols for _, cols in layout.dlt))


def backward_workspace(packed: Pack, n_pad: int, device) -> tuple:
    """The buffers a backward launch on ``n_pad`` points writes, in the
    order the C launchers take them: the tile-order activation and delta
    workspaces (bf16, :func:`workspace_planes`), the f32 partial sums of
    the weights (a CHUNK of points each) and of the biases (BIAS_ROWS
    each), the first reduction pass's sums of each, and grad_w, grad_b;
    then the sizes they take after them (e_w, e_b, CHUNK, group_w,
    group_b)."""
    e_w, e_b = packed.w.numel(), packed.b.numel()
    chunks, bias_rows = -(-n_pad // CHUNK), n_pad // BIAS_ROWS
    group_w, group_b = two_pass_group(chunks), two_pass_group(bias_rows)
    a_cols, d_cols = workspace_columns(packed.layout)
    bf = dict(dtype=torch.bfloat16, device=device)
    kw = dict(dtype=torch.float32, device=device)
    buffers = (torch.empty(n_pad * sum(a_cols), **bf),
               torch.empty(n_pad * sum(d_cols), **bf),
               torch.empty(chunks * e_w, **kw),
               torch.empty(-(-chunks // group_w) * e_w, **kw),
               torch.empty(bias_rows * e_b, **kw),
               torch.empty(-(-bias_rows // group_b) * e_b, **kw),
               torch.empty(e_w, **kw), torch.empty(e_b, **kw))
    return buffers, (e_w, e_b, CHUNK, group_w, group_b)


def detile(buf: torch.Tensor, n: int, n_pad: int, cols: int):
    """A tile-order plane (64-point groups, each ``[col / 8][point][col %
    8]``) as the row-major (n, cols) matrix of its first ``n`` points."""
    return buf.view(n_pad // GROUP, cols // 8, GROUP, 8).permute(0, 2, 1, 3) \
        .reshape(n_pad, cols)[:n]


def workspace_planes(layout: Layout, act: torch.Tensor, dlt: torch.Tensor,
                     n: int, n_pad: int) -> dict:
    """The backward's workspaces, de-tiled (:func:`detile`), as the
    row-major planes of the plain backward (first ``n`` rows) by the names
    of ``layout.act`` and ``layout.dlt``: ``h`` and ``d`` as lists, the
    planes named None left out."""
    planes = {"h": [], "d": []}
    for buf, named in ((act, layout.act), (dlt, layout.dlt)):
        at = 0
        for name, cols in named:
            plane = detile(buf[at:at + n_pad * cols], n, n_pad, cols)
            at += n_pad * cols
            if name in ("h", "d"):
                planes[name].append(plane)
            elif name is not None:
                planes[name] = plane
    return planes
