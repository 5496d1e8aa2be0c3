"""Halo exchange for one image whose width is split over ranks.

The port's counterpart of what GSPMD inserts for the JAX package's
``SRFlowSpatialPredictor`` (a collective-permute at every conv): inside
``ops.nn.width_sharded(group, index, count)`` each rank holds strip
``index`` of ``count`` equal NHWC strips along W, and every op with a
spatial extent reads its neighbours' edge columns through this module.

* ``exchange`` / ``exchange_many``: a strip with ``r`` columns of each
  neighbour's edge on each side that faces a neighbour, from one
  ``all_gather`` of every rank's two edge strips (under gloo one
  collective beats a ``send`` / ``recv`` pair to each side).  At the
  image's true edges no column is added: the op's own SAME zero padding
  acts there, as on the whole image.  A zero halo would be wrong for a
  chained 3x3: the middle activation at the pad is ``act(bias)``, not 0.
  A strip narrower than ``r``, or strips of unequal widths, raise on
  every rank (each rank's width rides in the gathered buffer); there is
  no fallback to gathering the whole image.
* ``crop``: the halo columns taken off again; ``apply(fn, r, xs)``:
  ``fn`` on the haloed strips with the scope suspended (the ops inside
  run as on a whole image), its outputs cropped back to the strip.  A
  SAME conv of radius r (K3, ``ops.nn.conv2d``) needs ``r`` columns; a
  conditional flow step, two chained 3x3 convs (K5, ``flows.cond_affine``),
  ``STEP_HALO`` = 2 (``step``), and its records, which a 3x3 conv and a
  grouped 3x3 conv make from the conditioning, 2 more: ``records`` keeps
  the step's 2 on every record, so that a step exchanges its state alone.
* ``global_columns``: a resize along W in global column coordinates
  (``ops/interp.py``): the source columns of this rank's output columns
  on the whole image's grid, with the halo they reach (a bilinear x2 at
  ``align_corners=True`` reads ``j (W - 1) / (2 W - 1)``, which depends
  on the whole width).  Every rank computes every rank's reach, so all
  agree on whether to exchange.

The scope itself, ``width_sharded`` and ``width_shard``, lives here with
the exchange it drives; ``ops.nn`` gives both under its own name.

``EXCHANGES`` counts the all_gathers (``exchanges``) and the bytes of
this rank's edge buffers sent into them (``bytes``) since
``reset_exchange_counts()``.
"""

import torch
import torch.distributed as dist

STEP_HALO = 2
EXCHANGES = {"exchanges": 0, "bytes": 0}
# (sp group, this rank's strip, strips) inside ``width_sharded``
_SP = None


class width_sharded:
    """``with width_sharded(group, index, count):`` scopes one image whose
    width is split over the ranks of ``group``: this rank holds strip
    ``index`` of ``count`` equal strips along W, at global columns
    ``index * width`` on.  The ops with a spatial extent then exchange
    halos with the neighbouring strips (the module docstring); ``count``
    1 is no sharding: every op as outside.  The enclosing scope comes back
    on exit, also on an exception."""

    def __init__(self, group, index, count):
        self.sp = (group, index, count)

    def __enter__(self):
        global _SP
        self.saved, _SP = _SP, self.sp
        return self

    def __exit__(self, *exc):
        global _SP
        _SP = self.saved
        return False


def width_shard():
    """(group, index, count) inside ``width_sharded`` over more than one
    strip, else None."""
    return _SP if _SP is not None and _SP[2] > 1 else None


def reset_exchange_counts():
    for k in EXCHANGES:
        EXCHANGES[k] = 0


def sides(r, index, count):
    """(columns on the left, on the right): ``r`` on each side that faces
    a neighbour, 0 at the image's true edges."""
    return (r if index > 0 else 0), (r if index < count - 1 else 0)


@torch.no_grad()
def exchange_many(xs, r, group, index, count):
    """Each NHWC strip of ``xs`` (one W, any B, H, C) with ``r`` columns of
    each neighbour's edge on the sides that face one (``sides``): one
    ``all_gather`` over ``group`` for them all.  Returns a list."""
    xs = list(xs)
    if r == 0 or count == 1:
        return xs
    w = xs[0].shape[2]
    if any(x.shape[2] != w for x in xs):
        raise ValueError("halo exchange: the tensors of one strip differ in "
                         f"width: {[tuple(x.shape) for x in xs]}")
    if w < r:
        raise ValueError(f"halo exchange: a strip of width {w} is narrower "
                         f"than its halo of {r}")
    edges = [torch.cat([x[:, :, :r], x[:, :, -r:]], 2) for x in xs]
    head = torch.tensor([float(w)], device=xs[0].device)
    buf = torch.cat([head] + [e.float().reshape(-1) for e in edges])
    got = [torch.empty_like(buf) for _ in range(count)]
    dist.all_gather(got, buf, group=group)
    EXCHANGES["exchanges"] += 1
    EXCHANGES["bytes"] += buf.numel() * buf.element_size()
    widths = torch.stack([g[0] for g in got]).tolist()
    if len(set(widths)) != 1:
        raise ValueError("halo exchange: the strips differ in width: "
                         f"{[int(v) for v in widths]}")
    out, off = [], 1
    for x, e in zip(xs, edges):
        n = e.numel()
        left, right = (got[i][off:off + n].reshape(e.shape).to(x.dtype)
                       if 0 <= i < count else None
                       for i in (index - 1, index + 1))
        # the left neighbour's right edge, the right neighbour's left edge
        parts = ([left[:, :, r:]] if left is not None else []) + [x] + (
            [right[:, :, :r]] if right is not None else [])
        out.append(torch.cat(parts, 2))
        off += n
    return out


def exchange(x, r, group, index, count):
    """``x`` (this rank's strip) with ``r`` columns of each neighbour's
    edge: ``exchange_many`` of one tensor."""
    return exchange_many([x], r, group, index, count)[0]


def crop(y, r, index, count):
    """``y`` without the ``r`` columns on each side that faces a neighbour
    (contiguous)."""
    left, right = sides(r, index, count)
    return y[:, :, left:y.shape[2] - right].contiguous()


def _map(fn, out):
    if isinstance(out, (list, tuple)):
        return type(out)(fn(t) for t in out)
    return fn(out)


def _run(fn, r, xs, cut):
    """``fn`` on ``xs`` with ``r`` columns of halo, the scope suspended;
    ``cut`` columns cropped off each side of its output that faces a
    neighbour."""
    group, index, count = width_shard()
    hs = exchange_many(xs, r, group, index, count)
    with width_sharded(None, 0, 1):
        out = fn(*hs)
    return _map(lambda t: crop(t, cut, index, count), out)


def apply(fn, r, xs):
    """Inside ``width_sharded``: ``fn(*haloed)`` on the strips ``xs``, each
    with ``r`` columns of its neighbours, run with the scope suspended;
    its output (a tensor or a list of them) cropped to the strip."""
    return _run(fn, r, xs, r)


def records(fn, ft):
    """Inside ``width_sharded``: the records ``fn(haloed ft)`` of a level
    (a list), from ``ft`` with ``2 * STEP_HALO`` columns of its
    neighbours, each kept with the ``STEP_HALO`` that a step reads."""
    return _run(fn, 2 * STEP_HALO, [ft], STEP_HALO)


def step(fn, x, cond, *args):
    """A conditional flow step ``fn(x, cond, *args)`` inside
    ``width_sharded``: ``cond`` carries ``STEP_HALO`` columns of each
    neighbour already (``records``, as ``flows.cond_affine_cache_batched``
    makes them inside the scope); the state ``x`` gets them here."""
    _, index, count = width_shard()
    left, right = sides(STEP_HALO, index, count)
    if cond.shape[2] != x.shape[2] + left + right:
        raise ValueError(
            f"width_sharded flow step: the records are {cond.shape[2]} "
            f"wide, the strip {x.shape[2]}: they must carry the step's "
            f"halo of {STEP_HALO} (precompute_ft inside the scope)")
    return apply(lambda h: fn(h, cond, *args), STEP_HALO, [x])


def global_columns(x, out_w, idx):
    """A resize along W inside ``width_sharded``.  ``x``: this rank's strip
    (B, H, w, C) of a ``count * w`` wide image; ``idx``: long index tensors
    over the ``count * out_w`` global output columns into the global input
    columns.  Returns (``x`` with the halo that any rank's output columns
    reach, each of ``idx`` cut to this rank's ``out_w`` output columns and
    shifted to the haloed strip's columns)."""
    group, index, count = width_shard()
    w = x.shape[2]
    rows = torch.stack([i.reshape(count, out_w) for i in idx]).cpu()
    first = torch.arange(count) * w
    reach = max(int((first - rows.amin((0, 2))).max()),
                int((rows.amax((0, 2)) - (first + w - 1)).max()), 0)
    x = exchange(x, reach, group, index, count)
    shift = index * w - sides(reach, index, count)[0]
    local = [i[index * out_w:(index + 1) * out_w] - shift for i in idx]
    return x, local
