"""The comparison with the plain reference that decides ``correct``.

Each phase yields a few numbers, each held to a limit of its own from
``portbench/limits/<workload>.json``; a run is correct when every number is
at or under its limit.

- training: the window's first three updates, made from the seeded start
  through the window's own call and feed, followed by the reference from
  the same weights on the same batches, with the same dropout stream.
  ``first_loss_gap``: the relative gap of the first step's loss
  (``loss_gap``: the worst of the three steps'). ``grad_norm_gap``: by the
  worst leaf, the gap between the norms of the program's and the
  reference's first gradient as the optimizer received it (the program's
  worked out from its optimizer state after one step), over the larger of
  the reference's norm of that leaf and the median leaf's;
  ``median_grad_gap``: the median leaf's. ``change_gap`` and
  ``median_change_gap``: the same of each parameter's change over the
  three updates, leaving out the leaves whose raw reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).
  A cell holds the numbers its limits file names; ``PERF.md`` says why
  each training cell holds which. ``batch_faults``: the data stage the
  comparison starts after, checked by itself: each row of the three
  batches worked out again by ``reference/augment.py`` from the written
  files, the benchmark's labelled pixels and the (epoch, image) the loader
  gave it; a row whose image differs counts 1, and so does each labelled
  pixel whose coordinate, label or validity differs, and each row repeated
  across the batches (exact, 0).
- validation: a sample of the last pass's images, drawn from the seed.
  ``pred_logit_gap``: the widest gap, in logits, by which the class the
  program predicted at a pixel lies below the reference's best there.
  ``hist_gap``: the program's confusion matrix of each sampled image
  against the one the reference counts from the program's prediction and
  the label (exact, 0).
- sweep: every image of the last sweep. ``pick_gap``: the least error in
  the reference's margins that explains the program's picks: how far a
  pick lies beyond the reference's candidate threshold (the
  ``top_n_percent`` smallest margins; labelled and void pixels count as
  margin 1, never a candidate), or how far inside it lies a pixel that
  was left out though its uniform draw beats the lowest pick's; the worst
  image's. ``entropy_gap``: the largest gap between the program's entropy
  at its picks and the reference's there.

Each phase's ``numbers`` calls the function of its kind here;
``numbers("tf32")`` computes the same numbers with the reference in TF32
put in the program's place: the control, the lower precision that
the check has to refuse (``calibrate.py``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import augment as ref_aug, steps as ref

PICK_SELECTOR_SEED = 1_000_003  # the port's per-sweep draw seed multiplier
BLOCK = 8  # images per reference forward


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _leaf_gaps(prog: Dict[str, float], refn: Dict[str, float],
               names: List[str]) -> List[float]:
    """Per leaf, the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf."""
    med = float(np.median([refn[n] for n in names]))
    return [abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30)
            for n in names]


def compare_train(prog: dict, refr: dict, p0: Dict[str, torch.Tensor],
                  wd: float) -> Dict[str, float]:
    """``prog`` and ``refr`` as ``reference/steps.py:train_steps`` returns
    them."""
    names = sorted(refr["first_grad"])
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], refr["losses"])]
    gp = {n: _norm(prog["first_grad"][n]) for n in names}
    gr = {n: _norm(refr["first_grad"][n]) for n in names}
    raw = {n: _norm(refr["first_grad"][n] - wd * p0[n]) for n in names}
    med_raw = float(np.median(list(raw.values())))
    moved = [n for n in names if raw[n] >= 1e-3 * med_raw]
    dp = {n: _norm(prog["params"][n] - p0[n]) for n in moved}
    dr = {n: _norm(refr["params"][n] - p0[n]) for n in moved}
    grad, change = _leaf_gaps(gp, gr, names), _leaf_gaps(dp, dr, moved)
    return {"first_loss_gap": losses[0],
            "median_grad_gap": float(np.median(grad)),
            "median_change_gap": float(np.median(change)),
            "loss_gap": max(losses), "grad_norm_gap": max(grad),
            "change_gap": max(change)}


def batch_faults(phase) -> int:
    """Faults of the data stage in the compared batches (see above)."""
    from PIL import Image

    cfg, c = phase.cfg, phase.captured
    labels, masks = phase.data.labels["train"], phase.masks
    files = phase.data.files["train"]
    bad, seen = 0, set()
    for b, (epoch, idxs) in zip(c["batches"], c["plans"]):
        coords = b["coords"].cpu().numpy()
        got = b["labels"].cpu().numpy()
        valid = b["valid"].cpu().numpy()
        xs = b["x"].cpu().numpy()
        for row, i in enumerate(idxs):
            i = int(i)
            bad += i in seen
            seen.add(i)
            with Image.open(files[i]) as im:
                x0 = im.convert("RGB")
            x, rr, cc, lab, ok = ref_aug.train_sample(
                x0, labels[i], masks[i],
                ref_aug.sample_rng(phase.port_seed, epoch, i), cfg)
            bad += int(x.shape != xs[row].shape
                       or not np.array_equal(x, xs[row]))
            n = len(rr)
            want = np.zeros((coords.shape[1], 4), np.int64)
            want[:n] = np.stack([rr, cc, lab, ok], 1)
            have = np.concatenate([coords[row], got[row][:, None],
                                   valid[row][:, None]], 1).astype(np.int64)
            have[n:] = 0  # past the labelled pixels: padding, not read
            bad += int((want != have).any(1).sum())
            bad += int(valid[row][n:].sum())
    return bad


def train_numbers(phase, prec: str = "f32") -> Dict[str, float]:
    cfg, c = phase.cfg, phase.captured
    wd = cfg["optimizer"]["weight_decay"]
    refr = ref.train_steps(phase.weights, c["batches"], cfg,
                           phase.dropout_seed, "f32")
    if prec == "f32":
        prog = {"losses": [float(x) for x in c["losses"]],
                "first_grad": c["first_grad"], "params": c["params"]}
    else:
        prog = ref.train_steps(phase.weights, c["batches"], cfg,
                               phase.dropout_seed, prec)
    out = compare_train(prog, refr, phase.weights, wd)
    out["batch_faults"] = batch_faults(phase)
    return out


def val_numbers(phase, prec: str = "f32") -> Dict[str, float]:
    cfg, n = phase.cfg, phase.cfg["n_classes"]
    idx = sorted(phase.kept)
    images = phase.data.images["val"]
    labels = phase.data.labels["val"]
    logit_gap, hist_gap = 0.0, 0
    for lo in range(0, len(idx), BLOCK):
        part = idx[lo:lo + BLOCK]
        x = torch.from_numpy(np.stack([images[i] for i in part])).to(
            phase.device)
        logits = ref.eval_logits(phase.weights, x, cfg, "f32")
        if prec == "f32":
            preds = torch.stack([phase.kept[i][0].reshape(logits.shape[2:])
                                 for i in part])
            hists = [phase.kept[i][1].cpu().numpy() for i in part]
        else:
            preds = ref.eval_logits(phase.weights, x, cfg, prec).argmax(1)
            hists = [ref.confusion(labels[i], p.cpu().numpy(), n)
                     for i, p in zip(part, preds)]
        best = logits.max(1).values
        got = torch.gather(logits, 1, preds[:, None].long())[:, 0]
        logit_gap = max(logit_gap, float((best - got).max()))
        for i, p, h in zip(part, preds, hists):
            counted = ref.confusion(labels[i], p.cpu().numpy(), n)
            hist_gap += int(np.abs(h - counted).sum())
    return {"pred_logit_gap": logit_gap, "hist_gap": hist_gap}


def sweep_numbers(phase, prec: str = "f32") -> Dict[str, float]:
    cfg = phase.cfg
    images = phase.data.images["train"]
    labels = phase.data.labels["train"]
    gen = torch.Generator(device=phase.device).manual_seed(
        (phase.port_seed * PICK_SELECTOR_SEED + phase.nth_query)
        & 0x7FFFFFFF)
    pick_gap = entropy_gap = 0.0
    at = 0
    for prog_idx, prog_ent in phase.kept:
        bsz = prog_idx.shape[0]
        sl = slice(at, at + bsz)
        at += bsz
        x = torch.from_numpy(np.stack(images[sl])).to(phase.device)
        y = torch.from_numpy(np.stack(labels[sl])).to(phase.device)
        excl = torch.from_numpy(np.stack(phase.masks[sl])).to(phase.device) \
            | (y == cfg["ignore_index"])
        u = torch.rand((bsz, x.shape[1] * x.shape[2]), generator=gen,
                       device=phase.device)
        logits = torch.cat([ref.eval_logits(phase.weights, x[i:i + BLOCK],
                                            cfg, "f32")
                            for i in range(0, bsz, BLOCK)])
        _, m, thr = ref.margin_picks(ref.margins(logits), excl, u,
                                     cfg["n_pixels_by_us"],
                                     cfg["top_n_percent"])
        if prec != "f32":
            low = torch.cat([ref.eval_logits(phase.weights, x[i:i + BLOCK],
                                             cfg, prec)
                             for i in range(0, bsz, BLOCK)])
            prog_idx, _, _ = ref.margin_picks(ref.margins(low), excl, u,
                                              cfg["n_pixels_by_us"],
                                              cfg["top_n_percent"])
            prog_ent = _entropy_at(low, prog_idx)
        pick_gap = max(pick_gap, float(_pick_gap(m, thr, u, prog_idx).max()))
        ent = _entropy_at(logits, prog_idx)
        entropy_gap = max(entropy_gap,
                          float((ent - prog_ent.float()).abs().max()))
    return {"pick_gap": pick_gap, "entropy_gap": entropy_gap}


def _pick_gap(m: torch.Tensor, thr: torch.Tensor, u: torch.Tensor,
              picks: torch.Tensor) -> torch.Tensor:
    """Per image, the least error in the reference's margins ``m`` (B, n;
    excluded pixels at 1) that explains ``picks`` (B, n_pixels): a pick
    that the reference does not hold a candidate lies ``m - thr`` beyond
    the threshold; a pixel left out whose draw beats the lowest pick's must
    not be a candidate, and it lies ``thr - m`` inside."""
    picked = torch.zeros_like(m, dtype=torch.bool).scatter_(1, picks, True)
    beyond = (torch.gather(m, 1, picks) - thr[:, None]).amax(1)
    lowest = torch.gather(u, 1, picks).amin(1)
    passed = (u > lowest[:, None]) & ~picked
    inside = torch.where(passed, thr[:, None] - m,
                         torch.full_like(m, -1.0)).amax(1)
    return torch.clamp(torch.maximum(beyond, inside), min=0.0)


def _entropy_at(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    bsz, c = logits.shape[:2]
    p = torch.softmax(logits.float(), 1).reshape(bsz, c, -1)
    p = torch.gather(p, 2, idx[:, None, :].expand(-1, c, -1))
    return -torch.where(p > 0, p * torch.log(p.clamp(min=1e-30)),
                        torch.zeros_like(p)).sum(1)


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a NaN is not)."""
    return all(k in values and values[k] <= limits[k] for k in limits)
