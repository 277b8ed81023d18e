"""Gradient-boosted trees: sklearn's ``GradientBoostingClassifier()`` at its
defaults, in torch, on the device of the data it is given.

The JAX package's DCI fits ``sklearn.ensemble.GradientBoostingClassifier()``
per factor (``encdiff_tpu/evalx/metrics/dci.py:57-70``): log loss, 100
stages (20 at the in-training tier), learning rate 0.1, regression trees of
depth 3 on the negative gradient (squared error, best splitter, every
feature a node, ``min_samples_split`` 2, ``min_samples_leaf`` 1), a Newton
step per leaf, no subsampling. This module follows sklearn 1.9's
``ensemble/_gb.py``, ``tree/_splitter.pyx`` (``node_split_best``),
``tree/_criterion.pyx`` (``MSE``), ``tree/_partitioner.pyx`` and
``tree/_tree.pyx`` (the depth-first builder) rule for rule:

* X is cast to float32; residuals, sums and leaf values are float64. A
  split position lies between two sorted values more than
  ``FEATURE_THRESHOLD`` apart; its threshold is the float64 midpoint of the
  two float32 values. A feature whose values in a node span at most
  ``FEATURE_THRESHOLD`` is constant there.
* A node is a leaf at depth 3, under 2 samples, at impurity <= ``EPSILON``,
  without a split position, or when the split's improvement + ``EPSILON``
  is below 0.
* Features are visited in the splitter's Fisher-Yates order, drawn with
  ``our_rand_r`` from one ``randint(0, RAND_R_MAX)`` per tree of numpy's
  global ``RandomState`` (sklearn's ``random_state=None``), with the
  known and newly found constant features kept the splitter's way; the
  first strictly better proxy improvement wins. The nodes draw in the builder's depth-first order.
* Leaves take the Newton step (multinomial: K trees a stage and the
  (K - 1) / K factor; binary: one tree); ``feature_importances_`` is the
  mean over trees with more than one node of the unnormalised impurity
  decreases, normalised.

Trees grow level by level: each feature is presorted once per fit, and a
pass computes, for every (tree, node, feature), the running sums of the
node's sorted residuals, every split position's proxy improvement and the
feature's best, in a few tensor ops over all the trees of a stage (the K
trees of each of the batched fits, ``fit_many``). The host keeps each
tree's splitter state and its depth-first stack, and reads a few numbers a
node (one copy a pass): it draws the feature order, picks the split and
asks the device to partition the node.

Sums follow sklearn's order: a node's totals run over its samples in the
splitter's arrangement (sorted by the last feature the node sorted, then
partitioned by the two-pointer swap of ``partition_samples_final``), a
split position's left sum runs forward in the feature's sorted order, or
back from the total where the criterion updates from the end. On the CPU
``torch.cumsum`` sums in that order, ``exp`` is libm's (as sklearn's
Cython calls it) and the leaf means are numpy's, so the trees equal
sklearn's tree for tree where sorted ties hold equal residuals (sklearn's
introsort may order unequal residuals of equal feature values otherwise).
On CUDA the scans and the leaf sums run in parallel and round otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.special
import scipy.stats
import torch
import torch.nn.functional as F

FEATURE_THRESHOLD = 1e-7
EPSILON = float(np.finfo(np.float64).eps)
RAND_R_MAX = 2147483647
MAX_DEPTH = 3
LEARNING_RATE = 0.1
#: heap slots of a tree of depth 3: node s has children 2s + 1 and 2s + 2
N_SLOTS = 2 ** (MAX_DEPTH + 1) - 1
#: elements of one (rows, features, positions) block of a pass; rows join
#: a block while they are at least half its longest, or, on the card
#: (where a block's cost is its launches), while it is small
BLOCK = 1 << 24
SMALL_BLOCK = 1 << 20

_libm_exp = np.frompyfunc(math.exp, 1, 1)


def _sklearn_order(t: torch.Tensor) -> bool:
    """Whether to round as sklearn does (libm's exp, numpy's leaf means):
    on the CPU."""
    return t.device.type == "cpu"


def _exp(t: torch.Tensor) -> torch.Tensor:
    """exp as sklearn's Cython loss takes it: libm's on the CPU."""
    if not _sklearn_order(t):
        return torch.exp(t)
    return torch.from_numpy(
        _libm_exp(t.numpy()).astype(np.float64)).reshape(t.shape)


class _Splitter:
    """The host half of sklearn's ``Splitter``: the feature order, the
    constant features and the ``our_rand_r`` state of one tree."""

    def __init__(self, seed: int, n_features: int):
        self.state = int(seed) & 0xFFFFFFFF
        self.features = list(range(n_features))
        self.constant_features = list(range(n_features))

    def draw(self, n_known: int, constant):
        """``node_split_best``'s feature loop: returns the non-constant
        features in visiting order, the features sorted in order and the
        constant count that the children inherit. ``our_rand_r`` and
        ``rand_int`` are inlined: the loop runs once a feature a node."""
        feats = self.features
        n = len(feats)
        f_i, n_found, n_drawn, n_visited = n, 0, 0, 0
        n_total = n_known
        visit, sorted_ = [], []
        state = self.state
        while f_i > n_total and (n_visited < n
                                 or n_visited <= n_found + n_drawn):
            n_visited += 1
            if state == 0:
                state = 1
            state ^= (state << 13) & 0xFFFFFFFF
            state ^= state >> 17
            state ^= (state << 5) & 0xFFFFFFFF
            f_j = n_drawn + (state % (RAND_R_MAX + 1)) % (
                f_i - n_found - n_drawn)
            if f_j < n_known:
                feats[n_drawn], feats[f_j] = feats[f_j], feats[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            feat = feats[f_j]
            sorted_.append(feat)
            if constant[feat]:
                feats[f_j], feats[n_total] = feats[n_total], feats[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            feats[f_i], feats[f_j] = feats[f_j], feats[f_i]
            visit.append(feat)
        self.state = state
        feats[:n_known] = self.constant_features[:n_known]
        self.constant_features[n_known:n_known + n_found] = \
            feats[n_known:n_known + n_found]
        return visit, sorted_, n_total


def _suffix(b: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix counts along dim 1, two zeros padded at the end."""
    return F.pad(b.long().flip(1).cumsum(1).flip(1), (0, 2))


def two_pointer_partition(lab: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Where ``partition_samples_final``'s two-pointer swap moves each
    element of rows of ``m`` elements labelled ``lab`` (True: left).

    Returns ``dest`` (rows, L): element e of a row ends at ``dest[e]``
    (the identity on padding). The front [0, nL) keeps its left elements;
    its k-th right element swaps with the k-th left element of the back
    counted from the end, and the right elements fill the back from the end
    in the order the scan meets them: a front right element, then the back
    right elements the swap pulls in before the next back left one, and at
    last the unvisited back rights from nL up.
    """
    R, L = lab.shape
    dev = lab.device
    lpos = torch.arange(L, device=dev).expand(R, L)
    vm = lpos < m[:, None]
    lab = lab & vm
    nl = lab.sum(1, keepdim=True)
    front = vm & (lpos < nl)
    back = vm & ~front
    front_r, back_l, back_r = front & ~lab, back & lab, back & ~lab
    k_f = front_r.long().cumsum(1)
    k_b = _suffix(back_l)
    s_br = _suffix(back_r)
    n_fr = front_r.sum(1, keepdim=True)
    dump = torch.full_like(lpos, L + 1)
    # pos_bl[k]: the k-th back left from the end (pos_bl[0] = m);
    # pos_fr[k]: the k-th front right
    pos_bl = m[:, None].expand(R, L + 2).clone()
    pos_bl.scatter_(1, torch.where(back_l, k_b[:, :L], dump), lpos)
    pos_fr = torch.zeros(R, L + 2, dtype=torch.long, device=dev)
    pos_fr.scatter_(1, torch.where(front_r, k_f, dump), lpos)
    q_tail = pos_bl.gather(1, n_fr)
    d_front = k_f + s_br.gather(
        1, (pos_bl.gather(1, (k_f - 1).clamp_min(0)) + 1).clamp_max(L + 1))
    nxt = (lpos + 1).clamp_max(L + 1)
    d_run = k_b.gather(1, nxt) + s_br.gather(1, nxt) + 2
    base = n_fr + s_br.gather(1, (q_tail + 1).clamp_max(L + 1))
    d_tail = torch.where(lpos == nl, base + 1, base + 1 + (q_tail - lpos))
    disc = torch.where(front_r, d_front,
                       torch.where(lpos > q_tail, d_run, d_tail))
    dest = torch.where(back_l, pos_fr.gather(1, k_b[:, :L].clamp_max(L + 1)),
                       lpos)
    return torch.where(vm & ~lab, m[:, None] - disc, dest)


class _Stage:
    """The device state of one stage's trees while they grow: each tree's
    arrangement of samples (``arr``, sklearn's ``samples``), each
    feature's sorted order partitioned by node (``perm``), and the slot of
    every sample; on the host, each slot's segment and sums."""

    def __init__(self, fit: "_Fit", neg: torch.Tensor):
        self.fit = fit
        T, N = neg.shape
        dev = neg.device
        self.neg = neg
        self.arr = torch.arange(N, device=dev).repeat(T, 1)
        self.perm = fit.presort.unsqueeze(0).repeat(T, 1, 1)
        self.node_of = torch.zeros(T, N, dtype=torch.long, device=dev)
        self.start = np.zeros((T, N_SLOTS), np.int64)
        self.size = np.zeros((T, N_SLOTS), np.int64)
        self.sum = np.zeros((T, N_SLOTS))
        self.sq = np.zeros((T, N_SLOTS))
        self.size[:, 0] = N
        self.sum[:, 0] = neg.cumsum(1)[:, -1].cpu().numpy()
        self.sq[:, 0] = (neg * neg).cumsum(1)[:, -1].cpu().numpy()

    def _rows(self, rows):
        dev = self.neg.device
        ti = np.array([r[0] for r in rows])
        s = np.array([r[1] for r in rows])
        return (torch.from_numpy(ti).to(dev), ti, s,
                torch.from_numpy(self.start[ti, s]).to(dev),
                torch.from_numpy(self.size[ti, s]).to(dev))

    def candidates(self, rows):
        """Every (node, feature)'s best split: proxy improvement, position
        (the left count), threshold, whether the feature is constant in the
        node and whether its values there are all equal. ``rows`` lists
        (tree, slot); they run in blocks of similar sizes."""
        D = self.fit.D
        out = [np.empty((len(rows), D)) for _ in range(3)]
        out += [np.empty((len(rows), D), bool) for _ in range(2)]
        size = self.size[[r[0] for r in rows], [r[1] for r in rows]]
        order = np.argsort(-size, kind="stable")
        small = 0 if self.fit.device.type == "cpu" else SMALL_BLOCK
        i = 0
        while i < len(order):
            L = size[order[i]]
            j = i + 1
            while (j < len(order) and (j + 1 - i) * D * L <= BLOCK
                   and (2 * size[order[j]] >= L
                        or (j + 1 - i) * D * L <= small)):
                j += 1
            block = order[i:j]
            for o, v in zip(out, self._candidates([rows[k] for k in block])):
                o[block] = v
            i = j
        return out

    def _candidates(self, rows):
        fit = self.fit
        t, ti, s, start, m = self._rows(rows)
        dev, R, D, N = fit.device, len(rows), fit.D, fit.N
        sum_total = torch.from_numpy(self.sum[ti, s]).to(dev)[:, None, None]
        L = int(self.size[ti, s].max())
        lp = torch.arange(L, device=dev)
        mcol = m[:, None, None]
        vm = lp < mcol                                        # (R, 1, L)
        pos = (start[:, None, None] + lp).clamp_max(N - 1)
        d = fit.d_ar[None, :, None]
        idx = self.perm.view(-1).take((t[:, None, None] * D + d) * N + pos)
        x = fit.xt64.view(-1).take(d * N + idx)               # (R, D, L)
        y = torch.where(vm, self.neg.view(-1).take(t[:, None, None] * N
                                                   + idx), 0.0)
        valid = vm & (lp >= 1)
        valid = valid & (x > F.pad(x[..., :-1], (1, 0)) + FEATURE_THRESHOLD)
        # the criterion's updates: forward from the previous split position,
        # or back from the end when that is the shorter way
        prevc = F.pad(torch.where(valid, lp, 0).cummax(-1).values[..., :-1],
                      (1, 0))
        rev = valid & ((lp - prevc) > (mcol - lp))
        sl = F.pad(y.cumsum(-1)[..., :-1], (1, 0))
        first = torch.where(rev, lp, L).amin(-1)               # (R, D)
        width = int((m[:, None] - first).max()) if bool(rev.any()) else 0
        if width > 0:
            self._tail(sl, y, rev, first, m, sum_total, width, L)
        sr = sum_total - sl
        nlf = lp.to(torch.float64)
        proxy = torch.where(valid, sl * sl / nlf + sr * sr / (mcol - nlf),
                            -torch.inf)
        best = proxy.argmax(-1, keepdim=True)
        val = proxy.gather(-1, best).squeeze(-1)
        thr = (x.gather(-1, (best - 1).clamp_min(0)) / 2.0
               + x.gather(-1, best) / 2.0).squeeze(-1)
        hi = x.gather(-1, (mcol - 1).expand(R, D, 1)).squeeze(-1)
        const = hi <= x[..., 0] + FEATURE_THRESHOLD
        # one copy to the host
        out = torch.stack([val, best.squeeze(-1).to(val.dtype), thr,
                           const.to(val.dtype),
                           (hi == x[..., 0]).to(val.dtype)]).cpu().numpy()
        return (out[0], out[1].astype(np.int64), out[2], out[3] > 0,
                out[4] > 0)

    @staticmethod
    def _tail(sl, y, rev, first, m, sum_total, width, L):
        """The left sums from the first update from the end on: the total
        less each sample from the end there, then forward updates add to
        it until the next update from the end."""
        dev = sl.device
        R, D, _ = sl.shape
        # the last ``width`` positions of each row, from the end: (R, D, W)
        k = torch.arange(width, device=dev)
        back = (m[:, None, None] - 1 - k).expand(R, D, width)
        yb = torch.where(back >= 0, -y.gather(-1, back.clamp_min(0)), 0.0)
        # revsub[p] = total - y[m-1] - ... - y[p], from the end
        revsub = torch.cat([sum_total.expand(R, D, 1), yb], -1).cumsum(-1)
        p = first[..., None] + k                               # (R, D, W)
        ok = p < m[:, None, None]
        pc = p.clamp(0, L - 1)
        is_rev = rev.gather(-1, pc)
        rs = revsub.gather(-1, (m[:, None, None] - p).clamp(0, width))
        prev = y.gather(-1, (pc - 1).clamp_min(0))
        # one exact running sum from each restart: zeros before it, the
        # restart's value, then the samples it adds
        seg = is_rev.long().cumsum(-1)
        acc = torch.zeros_like(rs)
        for j in range(1, int(seg.max()) + 1):
            here = seg == j
            acc = torch.where(here, torch.where(
                here & is_rev, rs, torch.where(here, prev, 0.0)).cumsum(-1),
                acc)
        rows = torch.arange(R * D, device=dev).view(R, D, 1) * L
        sl.view(-1)[(rows + pc)[ok]] = acc[ok]

    def partition(self, reqs):
        """Split nodes: ``reqs`` lists (tree, slot, feature, threshold, last
        sorted feature or -1, left count). Updates the arrangement, the
        sorted orders and the samples' slots; returns, per request, the
        children's forward sums and squares in the arrangement and the
        total less the right child's samples from the end."""
        fit = self.fit
        dev, N, D = fit.device, fit.N, fit.D
        t, ti, s, start, m = self._rows(reqs)
        R = len(reqs)
        feat = torch.tensor([r[2] for r in reqs], device=dev)
        thr = torch.tensor([r[3] for r in reqs], dtype=torch.float64,
                           device=dev)
        last = torch.tensor([r[4] for r in reqs], device=dev)
        nl_h = np.array([r[5] for r in reqs])
        nl = torch.from_numpy(nl_h).to(dev)[:, None]
        L = int(self.size[ti, s].max())
        lpos = torch.arange(L, device=dev).expand(R, L)
        vm = lpos < m[:, None]
        flat = (t[:, None] * N + (start[:, None] + lpos).clamp_max(N - 1))
        a = self.arr.view(-1).take(flat)
        key = torch.where(vm & (last[:, None] >= 0),
                          fit.xt32.view(-1).take(last.clamp_min(0)[:, None]
                                                 * N + a), torch.inf)
        a = a.gather(1, torch.sort(key, dim=1, stable=True).indices)
        lab = vm & (fit.xt64.view(-1).take(feat[:, None] * N + a)
                    <= thr[:, None])
        if not bool((lab.sum(1, keepdim=True) == nl).all()):
            raise RuntimeError("a split's left count disagrees with its "
                               "threshold")
        new = torch.empty_like(a).scatter_(1, two_pointer_partition(lab, m), a)
        self.arr.view(-1)[flat[vm]] = new[vm]
        slot = torch.from_numpy(s).to(dev)[:, None]
        self.node_of.view(-1)[(t[:, None] * N + a)[vm]] = torch.where(
            lab, 2 * slot + 1, 2 * slot + 2)[vm]
        self._partition_perm(reqs, ti, nl_h)
        # the children's sums in the arrangement
        y = self.neg.view(-1).take(t[:, None] * N + new)
        sum_l = y.cumsum(1).gather(1, nl - 1)
        sq_l = (y * y).cumsum(1).gather(1, nl - 1)
        yr = y.gather(1, (nl + lpos).clamp_max(L - 1))
        n_r = m[:, None] - nl
        sum_r = yr.cumsum(1).gather(1, n_r - 1)
        sq_r = (yr * yr).cumsum(1).gather(1, n_r - 1)
        total = torch.from_numpy(self.sum[ti, s]).to(dev)[:, None]
        tail = -y.gather(1, (m[:, None] - 1 - lpos).clamp_min(0))
        revsub = torch.cat([total, tail], 1).cumsum(1).gather(1, n_r)
        out = torch.cat([sum_l, sq_l, sum_r, sq_r, revsub], 1).cpu().numpy()
        for (tr, sl_, *_), n_left, row in zip(reqs, nl_h, out):
            st, sz = self.start[tr, sl_], self.size[tr, sl_]
            for c, c_start, c_size, c_sum, c_sq in (
                    (2 * sl_ + 1, st, n_left, row[0], row[1]),
                    (2 * sl_ + 2, st + n_left, sz - n_left, row[2], row[3])):
                self.start[tr, c] = c_start
                self.size[tr, c] = c_size
                self.sum[tr, c] = c_sum
                self.sq[tr, c] = c_sq
        return out

    def _partition_perm(self, reqs, ti, nl_h):
        """Every feature's sorted order, stably partitioned within each
        split segment: whole rows of the trees that split, integer ranks."""
        fit = self.fit
        dev, N = fit.device, fit.N
        trees = np.unique(ti)
        row_of = {tr: i for i, tr in enumerate(trees)}
        # per request: its row, segment, left count, the left and right
        # counts of the segments before it in its row, and its feature
        table = np.zeros((len(reqs), 7), np.int64)
        seen: dict = {}
        for r, (tr, sl_, feat, *_) in sorted(
                enumerate(reqs), key=lambda e: self.start[e[1][0], e[1][1]]):
            st, sz = self.start[tr, sl_], self.size[tr, sl_]
            bl, br = seen.get(tr, (0, 0))
            table[r] = (row_of[tr], st, sz, nl_h[r], bl, br, feat)
            seen[tr] = (bl + nl_h[r], br + sz - nl_h[r])
        tab = torch.from_numpy(table).to(dev)
        # the request of each position (-1: none), from a difference array
        ids = torch.arange(1, len(reqs) + 1, device=dev)
        diff = torch.zeros(len(trees), N + 1, dtype=torch.long, device=dev)
        diff.index_put_((tab[:, 0], tab[:, 1]), ids, accumulate=True)
        diff.index_put_((tab[:, 0], tab[:, 1] + tab[:, 2]), -ids,
                        accumulate=True)
        seg = diff.cumsum(1)[:, :N] - 1
        inseg = (seg >= 0)[:, None, :]
        per = tab[seg.clamp_min(0)]                             # (T', N, 7)
        thr = torch.tensor([r[3] for r in reqs], dtype=torch.float64,
                           device=dev)[seg.clamp_min(0)][:, None, :]
        rows = torch.from_numpy(trees).to(dev)
        perm = self.perm.index_select(0, rows)                  # (T', D, N)
        feat = per[..., 6][:, None, :]
        lab = inseg & (fit.xt64.view(-1).take(feat * N + perm) <= thr)
        right = inseg & ~lab
        st, nl, bl, br = (per[..., i][:, None, :] for i in (1, 3, 4, 5))
        dest = torch.where(lab, st + lab.long().cumsum(-1) - 1 - bl,
                           st + nl + right.long().cumsum(-1) - 1 - br)
        dest = torch.where(inseg, dest, torch.arange(N, device=dev))
        self.perm.index_copy_(
            0, rows, torch.empty_like(perm).scatter_(-1, dest, perm))


class _Tree:
    """The host half of one tree as sklearn's depth-first builder grows
    it."""

    def __init__(self, t: int, seed: int, n_features: int, n_samples: int):
        self.t = t
        self.splitter = _Splitter(seed, n_features)
        self.n_samples = float(n_samples)
        self.stack = [dict(slot=0, depth=0, impurity=None, n_known=0)]
        self.nodes: dict = {}   # slot -> record
        self.order: list = []   # slots in node-id order
        self.pending = None     # slot waiting for its partition
        # splits above the leaf level wait for their partition before the
        # walk goes on (a split that does not improve pushes no children,
        # which draw); those at depth 2 do not: their children are leaves
        self.deferred: set = set()

    def advance(self, stage: _Stage, cands: dict, results: dict, requests):
        """Run the builder until it needs the device: returns whether the
        tree is done."""
        t = self.t
        while True:
            for s in [s for s in self.deferred if (t, s) in results]:
                self._finish_split(stage, s, results.pop((t, s)))
                self.deferred.discard(s)
            if self.pending is not None:
                s = self.pending
                if (t, s) not in results:
                    return False
                self._finish_split(stage, s, results.pop((t, s)))
                self.pending = None
            if not self.stack:
                return not self.deferred
            rec = self.stack[-1]
            s = rec["slot"]
            n = int(stage.size[t, s])
            if rec["impurity"] is None:   # the root
                wn = float(n)
                rec["impurity"] = (float(stage.sq[t, s]) / wn
                                   - (float(stage.sum[t, s]) / wn) ** 2.0)
            leaf = (rec["depth"] >= MAX_DEPTH or n < 2
                    or rec["impurity"] <= EPSILON)
            if not leaf and (t, s) not in cands:
                return False
            self.stack.pop()
            node = dict(depth=rec["depth"], impurity=rec["impurity"], n=n,
                        leaf=True, feature=-2, threshold=-2.0)
            self.nodes[s] = node
            self.order.append(s)
            if leaf:
                continue
            val, pos, thr, const, flat = cands.pop((t, s))
            visit, sorted_, n_total = self.splitter.draw(rec["n_known"],
                                                         const)
            # sklearn's introsort leaves equal values where they are: the
            # arrangement is that of the last feature sorted whose values
            # are not all equal (-1: none)
            last = next((f for f in reversed(sorted_) if not flat[f]), -1)
            best, choice = -math.inf, None
            for f in visit:
                if val[f] > best:
                    best, choice = val[f], f
            if choice is None:
                continue
            node.update(feature=choice, threshold=float(thr[choice]),
                        n_left=int(pos[choice]), n_known=n_total)
            requests.append((t, s, choice, float(thr[choice]), last,
                             int(pos[choice])))
            if rec["depth"] + 1 < MAX_DEPTH:
                self.pending = s
            else:
                # its leaves take the next node ids (the builder pops them
                # right after it)
                self.deferred.add(s)
                self.order += [2 * s + 1, 2 * s + 2]

    def _finish_split(self, stage: _Stage, s: int, row):
        """``children_impurity`` and ``impurity_improvement`` of a chosen
        split, in sklearn's expression order; a leaf if it does not
        improve."""
        t = self.t
        node = self.nodes[s]
        sum_l_fwd, sq_l, _, _, revsub = (float(v) for v in row)
        wn = float(node["n"])
        wl = float(node["n_left"])
        wr = wn - wl
        total, sq_total = float(stage.sum[t, s]), float(stage.sq[t, s])
        sum_l = sum_l_fwd if wl <= wr else revsub
        sum_r = total - sum_l
        sq_r = sq_total - sq_l
        imp_l = sq_l / wl - (sum_l / wl) ** 2.0
        imp_r = sq_r / wr - (sum_r / wr) ** 2.0
        improvement = (wn / self.n_samples) * (
            node["impurity"] - (wr / wn * imp_r) - (wl / wn * imp_l))
        depth = node["depth"] + 1
        if improvement + EPSILON < 0.0:
            node.update(feature=-2, threshold=-2.0)
            if depth >= MAX_DEPTH:
                self.order.remove(2 * s + 1)
                self.order.remove(2 * s + 2)
            return
        node["leaf"] = False
        if depth >= MAX_DEPTH:
            for c, imp in ((2 * s + 1, imp_l), (2 * s + 2, imp_r)):
                self.nodes[c] = dict(depth=depth, impurity=imp, leaf=True,
                                     n=int(stage.size[t, c]), feature=-2,
                                     threshold=-2.0)
            return
        self.stack.append(dict(slot=2 * s + 2, depth=depth, impurity=imp_r,
                               n_known=node["n_known"]))
        self.stack.append(dict(slot=2 * s + 1, depth=depth, impurity=imp_l,
                               n_known=node["n_known"]))

    def leaf_map(self) -> np.ndarray:
        """slot -> the leaf its samples end in: the highest leaf on its
        path (a split that does not improve has partitioned all the
        same)."""
        out = np.zeros(N_SLOTS, np.int64)
        for s in range(N_SLOTS):
            path = [s]
            while path[-1] > 0:
                path.append((path[-1] - 1) // 2)
            for a in reversed(path):
                if a in self.nodes and self.nodes[a]["leaf"]:
                    out[s] = a
                    break
        return out

    def importances(self, n_features: int) -> np.ndarray:
        """``Tree.compute_feature_importances(normalize=False)``."""
        imp = np.zeros(n_features)
        for s in self.order:
            node = self.nodes[s]
            if node["leaf"]:
                continue
            left, right = self.nodes[2 * s + 1], self.nodes[2 * s + 2]
            imp[node["feature"]] += (
                float(node["n"]) * node["impurity"]
                - float(left["n"]) * left["impurity"]
                - float(right["n"]) * right["impurity"])
        return imp / float(self.nodes[0]["n"])


class _Fit:
    """The data of a batch of fits on one X."""

    def __init__(self, X, device):
        self.device = torch.device(device)
        x32 = torch.as_tensor(np.asarray(X, np.float32) if not isinstance(
            X, torch.Tensor) else X).to(self.device, torch.float32)
        self.N, self.D = x32.shape
        self.xt32 = x32.T.contiguous()
        self.xt64 = self.xt32.to(torch.float64)
        self.d_ar = torch.arange(self.D, device=self.device)
        self.presort = torch.sort(self.xt32, dim=1, stable=True).indices


def _init_raw(y_enc: np.ndarray, n_classes: int, n_rows: int) -> np.ndarray:
    """``_init_raw_predictions`` of the prior ``DummyClassifier``: (rows,
    trees) float64, numpy's and scipy's ops as sklearn calls them."""
    counts = np.bincount(y_enc, minlength=n_classes)
    prior = counts / counts.sum()
    proba = np.ones((n_rows, 1)) * prior
    eps = np.finfo(np.float64).eps
    if n_classes == 2:
        p = np.clip(proba[:, 1], eps, 1 - eps, dtype=np.float64)
        return scipy.special.logit(p).reshape(-1, 1)
    p = np.clip(proba, eps, 1 - eps, dtype=np.float64)
    return np.log(p / scipy.stats.gmean(p, axis=1)[:, None])


def _safe_divide(num: float, den: float) -> float:
    if abs(den) < 1e-150:
        return 0.0
    return float(num) / float(den)


class GradientBoostingClassifier:
    """``sklearn.ensemble.GradientBoostingClassifier`` at its defaults
    (log loss, depth 3, learning rate 0.1, subsample 1, the trees' seeds
    from numpy's global ``RandomState``), fitted on ``device``."""

    def __init__(self, n_estimators: int = 100, device="cpu"):
        self.n_estimators = n_estimators
        self.device = device

    def fit(self, X, y):
        fitted = fit_many(X, [y], n_estimators=self.n_estimators,
                          device=self.device)[0]
        self.__dict__.update(fitted.__dict__)
        return self

    def _raw_predict(self, X) -> torch.Tensor:
        """Raw predictions (rows, trees a stage), float64 on the device."""
        dev = torch.device(self.device)
        x = torch.as_tensor(np.asarray(X, np.float32) if not isinstance(
            X, torch.Tensor) else X).to(dev, torch.float32).to(torch.float64)
        n = x.shape[0]
        enc = np.searchsorted(self.classes_, self._train_labels)
        raw = torch.from_numpy(_init_raw(enc, len(self.classes_), n)).to(dev)
        feat = torch.from_numpy(self._feature).to(dev)
        thr = torch.from_numpy(self._threshold).to(dev)
        leaf = torch.from_numpy(self._leaf).to(dev)
        value = torch.from_numpy(self._value).to(dev)
        rows = torch.arange(n, device=dev)[None, :]
        for i in range(feat.shape[0]):
            node = torch.zeros(feat.shape[1], n, dtype=torch.long,
                               device=dev)
            for _ in range(MAX_DEPTH):
                f = feat[i].gather(1, node).clamp_min(0)
                go = x[rows, f] <= thr[i].gather(1, node)
                node = torch.where(leaf[i].gather(1, node), node,
                                   torch.where(go, 2 * node + 1,
                                               2 * node + 2))
            raw += (LEARNING_RATE * value[i].gather(1, node)).T
        return raw

    def predict(self, X) -> np.ndarray:
        raw = self._raw_predict(X)
        if raw.shape[1] == 1:
            enc = (raw[:, 0] >= 0).long()
        else:
            enc = raw.argmax(1)
        return self.classes_[enc.cpu().numpy()]

    @property
    def feature_importances_(self) -> np.ndarray:
        relevant = [imp for imp, count in zip(self._importances.reshape(
            -1, self._importances.shape[-1]), self._node_counts.ravel())
            if count > 1]
        if not relevant:
            return np.zeros(self._importances.shape[-1])
        avg = np.mean(relevant, axis=0, dtype=np.float64)
        return avg / np.sum(avg)


def _leaf_values(neg, y_ind, leaf_of, n_classes, trees):
    """The Newton step of every leaf: (trees, slots) float64 on the host,
    numpy's means on the CPU (sklearn's), sums on the device otherwise."""
    T = neg.shape[0]
    values = np.zeros((T, N_SLOTS))
    factor = np.array([(k - 1) / k if k > 2 else 1.0 for k in n_classes])
    if _sklearn_order(neg):
        negn, yn, ln = neg.numpy(), y_ind.numpy(), leaf_of.numpy()
        for t in range(T):
            for s in trees[t].order:
                if not trees[t].nodes[s]["leaf"]:
                    continue
                idx = np.nonzero(ln[t] == s)[0]
                neg_g = negn[t].take(idx)
                prob = yn[t].take(idx) - neg_g
                num = np.average(neg_g)
                if n_classes[t] > 2:
                    num *= (n_classes[t] - 1) / n_classes[t]
                den = np.average(prob * (1 - prob))
                values[t, s] = _safe_divide(num, den)
        return values
    # a batched product with the leaves' one-hot: the same sums every run
    # (atomic scatters would add in a varying order)
    prob = y_ind - neg
    parts = torch.stack([neg, prob * (1 - prob), torch.ones_like(neg)], 1)
    onehot = F.one_hot(leaf_of, N_SLOTS).to(torch.float64)
    s = torch.bmm(parts, onehot).permute(1, 0, 2).cpu().numpy()
    with np.errstate(invalid="ignore", divide="ignore"):
        num = s[0] / s[2] * factor[:, None]
        den = s[1] / s[2]
    for t in range(T):
        for slot in trees[t].order:
            if trees[t].nodes[slot]["leaf"]:
                values[t, slot] = _safe_divide(num[t, slot], den[t, slot])
    return values


def draw_seeds(ys, n_estimators: int) -> np.ndarray:
    """The trees' seeds of fits on each label vector of ``ys`` one after
    the other, from numpy's global ``RandomState`` (sklearn's
    ``check_random_state(None)``): (stages, trees a stage of every fit)."""
    rs = np.random.mtrand._rand
    parts = []
    for y in ys:
        k = len(np.unique(np.asarray(y).ravel()))
        k_trees = 1 if k == 2 else k
        parts.append(np.array([[rs.randint(0, RAND_R_MAX)
                                for _ in range(k_trees)]
                               for _ in range(n_estimators)],
                              np.int64).reshape(n_estimators, k_trees))
    return np.concatenate(parts, 1)


def fit_many(X, ys, n_estimators: int = 100, device="cpu", seeds=None):
    """Fit one ``GradientBoostingClassifier`` per label vector of ``ys``
    on the same ``X``, every tree of a stage of every fit in one pass.
    The fits draw their trees' seeds from numpy's global ``RandomState``
    in the order sklearn's fits one after the other would
    (``draw_seeds``), unless ``seeds`` gives them."""
    fit = _Fit(X, device)
    dev = fit.device
    groups, cols, n_classes = [], [], []
    raw_cols, y_cols = [], []
    for y in ys:
        y = np.asarray(y).ravel()
        classes, enc = np.unique(y, return_inverse=True)
        K = len(classes)
        if K < 2:
            raise ValueError(f"y contains {K} class; a minimum of 2 classes "
                             "is required")
        k_trees = 1 if K == 2 else K
        first = len(cols)
        cols.extend(range(first, first + k_trees))
        n_classes.extend([K] * k_trees)
        raw_cols.append(_init_raw(enc, K, fit.N))
        ind = (enc.astype(np.float64)[None, :] if K == 2 else
               (enc[None, :] == np.arange(K)[:, None]).astype(np.float64))
        y_cols.append(ind)
        groups.append((classes, y, first, k_trees))
    T = len(cols)
    if seeds is None:
        seeds = draw_seeds(ys, n_estimators)
    if seeds.shape != (n_estimators, T):
        raise ValueError(f"seeds {seeds.shape}, ({n_estimators}, {T}) "
                         "expected")
    raw = torch.from_numpy(np.concatenate(raw_cols, 1).T.copy()).to(dev)
    y_ind = torch.from_numpy(np.concatenate(y_cols, 0)).to(dev)
    shape = (n_estimators, T, N_SLOTS)
    feature = np.full(shape, -2, np.int64)
    threshold = np.full(shape, -2.0)
    leaf = np.ones(shape, bool)
    value = np.zeros(shape)
    importances = np.zeros((n_estimators, T, fit.D))
    node_counts = np.zeros((n_estimators, T), np.int64)
    slots = np.full(shape, -1, np.int64)
    for i in range(n_estimators):
        neg = _neg_gradient(raw, y_ind, groups)
        stage = _Stage(fit, neg)
        trees = [_Tree(t, seeds[i, t], fit.D, fit.N) for t in range(T)]
        cands = _as_dict([(t, 0) for t in range(T)],
                         stage.candidates([(t, 0) for t in range(T)]))
        results: dict = {}
        active = list(range(T))
        while active:
            requests: list = []
            active = [t for t in active
                      if not trees[t].advance(stage, cands, results,
                                              requests)]
            if not requests:
                if active:
                    raise RuntimeError("the tree builders stalled")
                break
            out = stage.partition(requests)
            for r, row in zip(requests, out):
                results[(r[0], r[1])] = row
            kids = [(r[0], c) for r in requests
                    for c in (2 * r[1] + 1, 2 * r[1] + 2)
                    if trees[r[0]].nodes[r[1]]["depth"] + 1 < MAX_DEPTH
                    and stage.size[r[0], c] >= 2]
            if kids:
                cands.update(_as_dict(kids, stage.candidates(kids)))
        maps = torch.from_numpy(np.stack([tr.leaf_map() for tr in trees])
                                ).to(dev)
        leaf_of = maps.gather(1, stage.node_of)
        vals = _leaf_values(neg, y_ind, leaf_of, n_classes, trees)
        raw += LEARNING_RATE * torch.from_numpy(vals).to(dev).gather(
            1, leaf_of)
        for t, tr in enumerate(trees):
            node_counts[i, t] = len(tr.nodes)
            slots[i, t, :len(tr.order)] = tr.order
            importances[i, t] = tr.importances(fit.D)
            for s, node in tr.nodes.items():
                leaf[i, t, s] = node["leaf"]
                feature[i, t, s] = node["feature"]
                threshold[i, t, s] = node["threshold"]
                value[i, t, s] = vals[t, s] if node["leaf"] else 0.0
    fitted = []
    for classes, y, first, k_trees in groups:
        sl = slice(first, first + k_trees)
        g = GradientBoostingClassifier(n_estimators, device)
        g.classes_ = classes
        g._train_labels = y
        g._feature = feature[:, sl].copy()
        g._threshold = threshold[:, sl].copy()
        g._leaf = leaf[:, sl].copy()
        g._value = value[:, sl].copy()
        g._importances = importances[:, sl].copy()
        g._node_counts = node_counts[:, sl].copy()
        g._slots = slots[:, sl].copy()
        fitted.append(g)
    return fitted


def _as_dict(rows, cands):
    return {r: tuple(c[i] for c in cands) for i, r in enumerate(rows)}


def _neg_gradient(raw: torch.Tensor, y_ind: torch.Tensor, groups):
    """The negative gradient of each fit's loss, as sklearn's Cython loss
    computes it: (trees, rows) float64."""
    neg = torch.empty_like(raw)
    for classes, _, first, k_trees in groups:
        r = raw[first:first + k_trees]
        y = y_ind[first:first + k_trees]
        if k_trees == 1:
            e = _exp(-r)
            grad = torch.where(r > -37, ((1 - y) - y * e) / (1 + e),
                               _exp(r) - y)
        else:
            e = _exp(r - r.amax(0, keepdim=True))
            grad = e / e.cumsum(0)[-1:] - y
        neg[first:first + k_trees] = -grad
    return neg
