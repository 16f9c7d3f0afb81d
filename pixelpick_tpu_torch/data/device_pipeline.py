"""Device-resident augmentation (``--device_augment``).

Counterpart of ``pixelpick_tpu/data/device_pipeline.py``, the branch for
datasets of one image shape (CamVid, the cached Cityscapes). The train
images, labels and query masks are staged on the device once; each batch is
then drawn there:

- the geometric augmentation (random scale U(0.5, 2), pad, random crop,
  horizontal flip; ``base_dataset.py:48-127``) as a separable inverse warp:
  two interpolation-matrix products per image, built from PIL-parity
  triangle taps (``warp``, JAX ``warp_sample`` :95-155). Labels and query
  masks take the nearest tap;
- the photometric augmentation (colour jitter in a shuffled order,
  greyscale, Gaussian blur; ``photometric``, JAX ``photometric_device``
  :195-259), the blur as two more matrix products;
- the labelled pixels of the augmented query mask as the sparse step's
  coordinates, labels and valid mask (``sparse_coords``, JAX
  ``sparse_coords_device`` :271-290).

The random draws are kept apart from the math: ``DevicePipeline.draw``
samples each batch's per-sample draws on the device from a
``torch.Generator``, and ``augment`` takes them as an argument, so that the
tests can feed it the draws that JAX's keys give. Every function works on
the whole batch at once. The products run in strict f32 whatever the
process's TF32 setting, as JAX's run at ``precision="highest"``.

Variable-size datasets (VOC; JAX ``_stack_dataset`` :417-440,
``set_queries`` :447-456) stage each base-resized image zero-padded to the
set's largest (h, w), labels filled with the ignore index and query masks
with False, beside an ``hw`` tensor of the true sizes. The warp's
interpolation matrices span the staging extent, but every tap and every
nearest tap is clipped to the row's true extent, and the scale and crop
are drawn from it: the pad region is never read.

Under data parallelism (``parallel/mesh.py``) every rank stages the whole
set, draws for the whole global batch and augments only its rows.
"""

from __future__ import annotations

import copy
import math
from contextlib import contextmanager

import numpy as np
import torch

from pixelpick_tpu_torch.parallel import distributed, mesh


@contextmanager
def strict_f32():
    """cuBLAS f32 products without TF32 inside the block: TF32 rounds the
    tap weights and the 0-255 pixels to 10 mantissa bits."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --------------------------- geometric warp ---------------------------

def scaled_size(src_len, rs: torch.Tensor) -> torch.Tensor:
    """int(src_len * rs), the scaled extent, computed in f32 as JAX does.
    ``src_len``: an int, or (B,) per-row true extents."""
    return torch.floor(src_len * rs).to(torch.int32)


def _rows(src_len, ndim: int):
    """An int as it is; per-row (B,) extents shaped to broadcast against
    (B, ...) of ``ndim`` dimensions."""
    if isinstance(src_len, int):
        return src_len
    return src_len.reshape(-1, *(1,) * (ndim - 1))


def _warp_coords(src_len, scaled_len, offset, coords_out):
    """Output index -> continuous source coordinate through scale and crop
    (JAX ``_warp_coords`` :64-70, the same f32 operations in the same
    order). ``coords_out`` (n,) or (B, n); ``src_len`` an int or (B,);
    ``scaled_len``, ``offset`` (B,). Returns (u, pos), both (B, n)."""
    pos = coords_out.to(torch.float32) + offset.to(torch.float32)[:, None]
    scaled = scaled_len.to(torch.float32)
    # a true division (a number over a tensor is a reciprocal and a product
    # in torch, rounded twice)
    src = torch.full_like(scaled, float(src_len)) \
        if isinstance(src_len, int) else src_len.to(torch.float32)
    return (pos + 0.5) * (src / scaled)[:, None] - 0.5, pos


def _tap_weights(u, src_len, fscale, n_taps: int = 4):
    """PIL's BILINEAR taps for one axis (JAX ``_tap_weights`` :73-92): the
    triangle filter's support widened by ``fscale = max(1/rs, 1)`` on a
    downscale, taps floor(u)-1 .. floor(u)+2, out-of-image taps dropped and
    the rest renormalised. ``src_len``: the true extent, an int or (B,)
    per row; taps are clipped to it. Returns (idx clipped, weights),
    (..., n_taps)."""
    base = torch.floor(u).to(torch.int32)
    offs = torch.arange(-1, n_taps - 1, dtype=torch.int32, device=u.device)
    idx = base[..., None] + offs
    dist = (idx.to(torch.float32) - u[..., None]) / fscale[..., None]
    wt = torch.clamp(1.0 - dist.abs(), min=0.0)
    lim = _rows(src_len, idx.ndim)
    wt = wt * ((idx >= 0) & (idx < lim))
    wt = wt / torch.clamp(wt.sum(-1, keepdim=True), min=1e-8)
    return idx.clamp(min=0).clamp(max=lim - 1), wt


def _interp_matrix(u, src_len, fscale, extent: int) -> torch.Tensor:
    """(B, n, extent): row i holds output i's tap weights over a staging
    extent of ``extent`` pixels, the taps clipped to the true ``src_len``.
    The in-image taps of a row are distinct, so each entry is one weight
    (plus zeros of dropped taps) and the build is deterministic."""
    idx, wt = _tap_weights(u, src_len, fscale)
    m = torch.zeros((*u.shape, extent), dtype=torch.float32, device=u.device)
    return m.scatter_add_(-1, idx.long(), wt)


def _apply_rows(m, x):
    """out[b, s, w, c] = sum_h m[b, s, h] x[b, h, w, c]."""
    b, h, w, c = x.shape
    return torch.bmm(m, x.reshape(b, h, w * c)).reshape(b, -1, w, c)


def _apply_cols(m, x):
    """out[b, s, t, c] = sum_w m[b, t, w] x[b, s, w, c]."""
    b, s, w, c = x.shape
    xt = x.permute(0, 2, 1, 3).reshape(b, w, s * c)
    return torch.bmm(m, xt).reshape(b, -1, s, c).permute(0, 2, 1, 3)


def warp(x, y, q, draws: dict, crop_hw, *, mean_fill, ignore_index: int,
         src_hw=None):
    """Apply each sample's scale, crop and flip (JAX ``warp_sample``).

    x uint8 (B, H, W, 3), y int (B, H, W), q bool (B, H, W); ``draws``
    holds rs (B,) f32, top, left (B,) int and flip (B,) bool. ``src_hw``
    (B, 2) int: each row's true (h, w) when the arrays are padded to a
    common staging shape; every tap is clipped to it, so the pad is never
    read. Returns x f32 (B, ch, cw, 3) with ``mean_fill`` outside the
    scaled image, y int32 (``ignore_index`` outside) and q bool (False
    outside)."""
    _, hs, ws = x.shape[:3]  # the staging extent
    h, w = (hs, ws) if src_hw is None else (src_hw[:, 0], src_hw[:, 1])
    ch, cw = crop_hw
    dev = x.device
    rs = draws["rs"]
    sh, sw = scaled_size(h, rs), scaled_size(w, rs)
    i1 = torch.arange(ch, dtype=torch.int32, device=dev)
    j1 = torch.arange(cw, dtype=torch.int32, device=dev)
    jj = torch.where(draws["flip"][:, None], cw - 1 - j1, j1)

    u, pos_i = _warp_coords(h, sh, draws["top"], i1)     # (B, ch)
    v, pos_j = _warp_coords(w, sw, draws["left"], jj)    # (B, cw)
    inside = (pos_i < sh[:, None])[:, :, None] \
        & (pos_j < sw[:, None])[:, None, :]

    fscale = torch.clamp(torch.reciprocal(rs), min=1.0)[:, None]
    with strict_f32():
        xo = _apply_rows(_interp_matrix(u, h, fscale, hs),
                         x.to(torch.float32))
        xo = _apply_cols(_interp_matrix(v, w, fscale, ws), xo)
    fill = torch.as_tensor(np.asarray(mean_fill, np.float32), device=dev)
    xo = torch.where(inside[..., None], xo, fill)

    # half to even, clipped to the true extent
    un = torch.round(u).to(torch.int64).clamp(min=0).clamp(max=_rows(h, 2) - 1)
    vn = torch.round(v).to(torch.int64).clamp(min=0).clamp(max=_rows(w, 2) - 1)

    def nearest(a):
        rows = torch.gather(a, 1, un[:, :, None].expand(-1, -1, ws))
        return torch.gather(rows, 2, vn[:, None, :].expand(-1, ch, -1))

    yo = torch.where(inside, nearest(y).to(torch.int32), ignore_index)
    qo = nearest(q) & inside
    return xo, yo, qo


# --------------------------- photometric ---------------------------

def _gray(x):
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _adjust_hue(x, factor):
    """x (B, h, w, 3) in [0, 255]; shift the hue by ``factor`` (B, 1, 1) of
    a turn through HSV (JAX ``_adjust_hue`` :164-192)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    c = maxc - minc
    s = torch.where(maxc > 0, c / torch.clamp(maxc, min=1e-8), 0.0)
    safe_c = torch.clamp(c, min=1e-8)
    hr = torch.remainder((g - b) / safe_c, 6.0)
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    hue = torch.where(maxc == r, hr, torch.where(maxc == g, hg, hb)) / 6.0
    hue = torch.where(c == 0, 0.0, hue)
    hue = torch.remainder(hue + factor, 1.0)
    i = torch.floor(hue * 6.0)
    f = hue * 6.0 - i
    p = v * (1 - s)
    qq = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)
    # the sextant's (r, g, b) as jnp.select picks them
    table = ((v, t, p), (qq, v, p), (p, v, t), (p, qq, v), (t, p, v),
             (v, p, qq))
    out = []
    for ch in range(3):
        val = table[5][ch]
        for k in range(4, -1, -1):
            val = torch.where(i == k, table[k][ch], val)
        out.append(val)
    return torch.stack(out, -1)


def blur_matrix(g, n: int) -> torch.Tensor:
    """(B, n, n): the 1-D Gaussian blur with taps ``g`` (B, k) over ``n``
    pixels, edge-padded, as a matrix. Row i holds g[t] at column
    i + t - r; the taps that fall off an edge land on the edge pixel.
    Built by gathers and prefix sums, so it is the same on every run."""
    k = g.shape[1]
    r = k // 2
    if n < k:
        raise ValueError(f"a blur of {k} taps over {n} pixels")
    dev = g.device
    i = torch.arange(n, device=dev)
    d = i[None, :] - i[:, None] + r                      # tap of (i, j)
    m = g[:, d.clamp(0, k - 1)] * ((d >= 0) & (d < k))
    cum = g.cumsum(1)
    lo = r - i                    # taps 0..r-i land on pixel 0
    m[:, :, 0] = torch.where(lo >= 0, cum[:, lo.clamp(0, k - 1)], 0.0)
    hi = (n - 1 + r) - i          # taps hi..k-1 land on pixel n-1
    tail = cum[:, -1:] - torch.where(hi >= 1, cum[:, (hi - 1).clamp(0, k - 1)],
                                     0.0)
    m[:, :, n - 1] = torch.where(hi < k, tail, 0.0)
    return m


def photometric(x, draws: dict, *, blur_kernel: int = 0, enabled=None):
    """Colour jitter, greyscale and Gaussian blur on x f32 (B, h, w, 3) in
    [0, 255] (JAX ``photometric_device``; torchvision's semantics,
    ``base_dataset.py:129-141``).

    ``draws``: jitter (B,) bool and its factors f_b, f_c, f_s, f_h (B,),
    order (B, 4), a permutation of (brightness, contrast, saturation, hue)
    per sample; gray (B,) bool; blur (B,) bool and sigma (B,). An op that
    ``enabled`` turns off is not computed."""
    enabled = enabled or {}

    def per_sample(v):
        return v.to(torch.float32)[:, None, None, None]

    if enabled.get("random_color_jitter", True):
        f_b, f_c, f_s = (per_sample(draws[k]) for k in ("f_b", "f_c", "f_s"))
        f_h = draws["f_h"].to(torch.float32)[:, None, None]

        def brightness(z):
            return torch.clamp(z * f_b, 0, 255)

        def contrast(z):
            mean = torch.round(_gray(z)).mean((1, 2))[:, None, None, None]
            return torch.clamp(z * f_c + (1 - f_c) * mean, 0, 255)

        def saturation(z):
            return torch.clamp(z * f_s + (1 - f_s) * _gray(z)[..., None], 0,
                               255)

        def hue(z):
            return torch.clamp(_adjust_hue(z, f_h), 0, 255)

        ops = (brightness, contrast, saturation, hue)
        z = x
        for pos in range(4):
            which = draws["order"][:, pos][:, None, None, None]
            nxt = z
            for k, op in enumerate(ops):
                nxt = torch.where(which == k, op(z), nxt)
            z = nxt
        x = torch.where(draws["jitter"][:, None, None, None], z, x)

    if enabled.get("random_grayscale", True):
        gray = torch.round(_gray(x))[..., None].expand_as(x)
        x = torch.where(draws["gray"][:, None, None, None], gray, x)

    if enabled.get("random_gaussian_blur", True) and blur_kernel > 1:
        r = blur_kernel // 2
        t = torch.arange(-r, r + 1, dtype=torch.float32, device=x.device)
        sigma = draws["sigma"].to(torch.float32)[:, None]
        g = torch.exp(-(t ** 2) / (2 * sigma ** 2))
        g = g / g.sum(1, keepdim=True)
        with strict_f32():
            xb = _apply_rows(blur_matrix(g, x.shape[1]), x)
            xb = _apply_cols(blur_matrix(g, x.shape[2]), xb)
        x = torch.where(draws["blur"][:, None, None, None], xb, x)
    return x


# --------------------------- sparse extraction ---------------------------

def sparse_coords(q, y, ignore_index: int, k_max: int):
    """The labelled pixels of each augmented query mask q (B, h, w): coords
    (B, k_max, 2) int32 as (row, col), labels (B, k_max) int32, valid
    (B, k_max) bool (a pick whose label is void is not valid) and overflow
    (B,), the labelled pixels beyond ``k_max`` that were dropped (JAX
    ``sparse_coords_device``, whose top-k leaves the order open). Here the
    first ``k_max`` in raster order, the host extractor's order
    (``data/base.py:extract_sparse_labels``)."""
    b, _, w = q.shape
    flat = q.reshape(b, -1)
    n = flat.sum(1)
    rank = flat.cumsum(1) - 1
    slot = torch.where(flat & (rank < k_max), rank, k_max)  # k_max: discard
    pos = torch.arange(flat.shape[1], device=q.device).expand(b, -1)
    idx = torch.zeros((b, k_max + 1), dtype=torch.int64, device=q.device)
    idx = idx.scatter_(1, slot, pos)[:, :k_max]
    picked = torch.arange(k_max, device=q.device)[None, :] < n[:, None]
    labels = torch.gather(y.reshape(b, -1), 1, idx).to(torch.int32)
    coords = torch.stack([idx // w, idx % w], -1).to(torch.int32)
    valid = picked & (labels != ignore_index)
    return coords, labels, valid, torch.clamp(n - k_max, min=0)


# --------------------------- pipeline ---------------------------

class HostCopy:
    """A device tensor's copy to the host, started without waiting;
    ``get()`` waits for that copy alone, not for the work queued after it."""

    def __init__(self, t: torch.Tensor):
        self._host = t.to("cpu", non_blocking=True)
        self._event = None
        if t.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def get(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


class DevicePipeline:
    """A train set staged on ``device``, and augmented sparse batches drawn
    from it (JAX ``DevicePipeline`` :295-490).

    ``pad_multiple``: remainder batches are padded with duplicate indices
    to a multiple of it (the driver sets the micro-batch size), and of the
    world size too when ``pad_to_devices`` (the driver sets it when the
    full batches shard, JAX :458-486); the pad rows are masked out of
    ``valid`` and the overflow. ``micro_bs``: under data parallelism each
    micro-batch of a megabatch is sharded on its own (0: the batch is one
    update)."""

    def __init__(self, dataset, args, device):
        self.device = torch.device(device)
        self.pad_multiple = 1
        self.pad_to_devices = False
        self.micro_bs = 0
        self.ignore_index = dataset.ignore_index
        # staging reads every image once: keep those reads out of the
        # dataset's host caches, which this path never reads again
        prev_cache = dataset.cache_images
        dataset.cache_images = False
        try:
            xs, ys, hw = self._stack(dataset)
        finally:
            dataset.cache_images = prev_cache
        self.images = torch.from_numpy(xs).to(self.device)   # uint8
        self.labels = torch.from_numpy(ys).to(self.device)   # int32
        # the true (h, w) of each staged image of a variable-size set
        self.hw = None if hw is None else torch.from_numpy(hw).to(self.device)
        self.queries = None
        self.crop_hw = tuple(dataset.crop_size)
        self.k_max = int(dataset.k_max)
        self.mean = torch.tensor(np.asarray(args.mean, np.float32),
                                 device=self.device)
        self.std = torch.tensor(np.asarray(args.std, np.float32),
                                device=self.device)
        self.mean_fill = np.asarray(dataset.mean_fill, np.float32)
        self.geo = dict(dataset.geometric_augmentations)
        self.photo = dict(dataset.photometric_augmentations)
        self.jitter = tuple(dataset.jitter)
        self.blur_kernel = int((0.1 * min(self.crop_hw)) // 2 * 2 + 1) \
            if self.photo.get("random_gaussian_blur", True) else 0

    def _stack(self, dataset):
        """(images, labels, hw) host stacks. A variable-size set's
        base-resized images are zero-padded to the largest (h, w), labels
        with the ignore index, beside their true sizes (JAX
        ``_stack_dataset``); hw is None for a uniform set."""
        n = len(dataset)
        if not getattr(dataset, "variable_size", False):
            xs = np.stack([dataset._load_x(i) for i in range(n)])
            ys = np.stack([dataset._load_y(i) for i in range(n)])
            return xs, ys.astype(np.int32), None
        samples = []
        for i in range(n):
            x, y = dataset._base_resized(i)
            samples.append((np.asarray(x, np.uint8), np.asarray(y, np.int32)))
        hw = np.array([x.shape[:2] for x, _ in samples], np.int32)
        sh, sw = hw.max(0)
        xs = np.zeros((n, sh, sw, 3), np.uint8)
        ys = np.full((n, sh, sw), self.ignore_index, np.int32)
        for i, (x, y) in enumerate(samples):
            xs[i, :x.shape[0], :x.shape[1]] = x
            ys[i, :y.shape[0], :y.shape[1]] = y
        return xs, ys, hw

    @property
    def staged_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.images, self.labels, self.queries, self.hw)
                   if t is not None)

    def to(self, device) -> "DevicePipeline":
        """A copy whose staged tensors lie on ``device`` (to hold the card's
        batches against the CPU's on the same draws)."""
        out = copy.copy(self)
        out.device = torch.device(device)
        for k in ("images", "labels", "queries", "hw", "mean", "std"):
            t = getattr(self, k)
            setattr(out, k, None if t is None else t.to(out.device))
        return out

    def set_queries(self, queries_list) -> None:
        """Stage the query masks; a variable-size set's padded to the
        staging shape with False (JAX ``set_queries`` :447-456)."""
        if self.hw is None:
            qs = np.stack(queries_list)
        else:
            qs = np.zeros((len(queries_list), *self.images.shape[1:3]), bool)
            for i, q in enumerate(queries_list):
                qs[i, :q.shape[0], :q.shape[1]] = q
        self.queries = torch.from_numpy(qs).to(self.device)

    def draw(self, n: int, generator: torch.Generator, hw=None) -> dict:
        """Each sample's draws, on the device: every draw is made whatever
        the gates, so a batch consumes the same stream in every mode.
        ``hw`` (n, 2): the samples' true sizes, from which the crop
        offsets are drawn (default: the staged extent)."""
        dev = self.device

        def uniform(lo=0.0, hi=1.0, shape=(n,)):
            return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                               device=dev)

        h, w = self.images.shape[1:3] if hw is None else (hw[:, 0], hw[:, 1])
        ch, cw = self.crop_hw
        bf, cf, sf, hf = self.jitter
        d = {"rs": uniform(0.5, 2.0), "u_top": uniform(), "u_left": uniform(),
             "flip": uniform() > 0.5, "jitter": uniform() < 0.8,
             "f_b": uniform(max(0, 1 - bf), 1 + bf),
             "f_c": uniform(max(0, 1 - cf), 1 + cf),
             "f_s": uniform(max(0, 1 - sf), 1 + sf),
             "f_h": uniform(-hf, hf),
             "order": uniform(shape=(n, 4)).argsort(1),
             "gray": uniform() < 0.2, "blur": uniform() < 0.5,
             "sigma": uniform(0.1, 2.0)}
        if not self.geo.get("random_scale", True):
            d["rs"] = torch.ones_like(d["rs"])
        if not self.geo.get("random_hflip", True):
            d["flip"] = torch.zeros_like(d["flip"])
        # top, left uniform on [0, max(scaled, crop) - crop]
        for key, src, crop in (("top", h, ch), ("left", w, cw)):
            u = d.pop(f"u_{key}")
            room = torch.clamp(scaled_size(src, d["rs"]), min=crop) - crop
            off = torch.minimum(torch.floor(u * (room + 1).float()).long(),
                                room.long())
            d[key] = off if self.geo.get("crop", True) \
                else torch.zeros_like(off)
        return d

    def augment(self, indices: torch.Tensor, draws: dict,
                real: torch.Tensor) -> dict:
        """The batch of ``indices`` (device int64) under ``draws``; ``real``
        (B,) bool marks the rows that are not padding. Returns x normalised
        f32 (B, ch, cw, 3), coords, labels, valid (pad rows False) and
        overflow (a device scalar over the real rows)."""
        xa, ya, qa = warp(self.images[indices], self.labels[indices],
                          self.queries[indices], draws, self.crop_hw,
                          mean_fill=self.mean_fill,
                          ignore_index=self.ignore_index,
                          src_hw=None if self.hw is None
                          else self.hw[indices])
        xa = photometric(xa, draws, blur_kernel=self.blur_kernel,
                         enabled=self.photo)
        xn = (xa / 255.0 - self.mean) / self.std
        coords, labels, valid, over = sparse_coords(
            qa, ya, self.ignore_index, self.k_max)
        valid = valid & real[:, None]
        return {"x": xn, "coords": coords, "labels": labels, "valid": valid,
                "overflow": (over * real).sum()}

    def sample_batch(self, indices, generator: torch.Generator) -> dict:
        """An augmented batch of the dataset ``indices``, padded to a
        multiple of ``pad_multiple`` (and of the world size when
        ``pad_to_devices``) with copies of the last index. Under data
        parallelism the draws are the whole padded batch's, and only this
        rank's rows are augmented (``parallel/mesh.py:megabatch_rows``).
        Besides ``augment``'s keys: ``n_real``; ``global_rows``, the padded
        batch's row count; ``shard``, this rank's rows of a one-update
        batch (None: all); and ``rows_real``, a ``HostCopy`` of which of
        the rank's rows hold a valid pick, for the micro-batch step's no-op
        rule."""
        if self.queries is None:
            raise RuntimeError("DevicePipeline.set_queries() was not called")
        indices = np.array(indices, np.int64)  # a copy: any strides
        n_real = len(indices)
        mult = self.pad_multiple
        if self.pad_to_devices:
            mult = math.lcm(mult, distributed.world_size())
        target = -(-n_real // mult) * mult
        if target != n_real:
            indices = np.concatenate(
                [indices, np.repeat(indices[-1:], target - n_real)])
        idx = torch.from_numpy(indices).to(self.device)
        draws = self.draw(target, generator) if self.hw is None \
            else self.draw(target, generator, self.hw[idx])
        pos, shard = mesh.megabatch_rows(target, self.micro_bs or target)
        rows = torch.arange(target, device=self.device)
        if pos is not None:
            rows = torch.from_numpy(pos).to(self.device)
            idx, draws = idx[rows], {k: v[rows] for k, v in draws.items()}
        batch = self.augment(idx, draws, rows < n_real)
        if pos is not None:  # the global batch's overflow
            torch.distributed.all_reduce(batch["overflow"])
        batch.update(n_real=n_real, global_rows=target,
                     shard=None if self.micro_bs else shard,
                     rows_real=HostCopy(batch["valid"].any(1)))
        return batch
