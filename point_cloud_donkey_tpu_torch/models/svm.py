"""Chi-square-kernel C-SVC on the global descriptors (port of
point_cloud_donkey_tpu/models/svm.py, the reference's CustomSVM,
classifier/custom_SVM.cpp).

  * kernel: OpenCV CHI2, K(x, y) = exp(-gamma * sum (x_i - y_i)^2 /
    (x_i + y_i)) (custom_SVM.cpp:414-427);
  * modes: pairwise 1-vs-1 multiclass in one model, or N binary 1-vs-all
    models (the rest relabelled -1, custom_SVM.cpp:60-105);
  * scores: pairwise sums the sigmoids of the pair decision values per
    class over (n - 1) (custom_SVM.cpp:430-520); 1-vs-all remaps the raw
    decision values by (1 - score) / 2 (custom_SVM.cpp:302-320);
  * trainAuto: a k-fold grid search over (C, gamma), the reference's
    coarse grid then a refined grid around the winner
    (custom_SVM.cpp:199-270).

It stays on the host, in numpy, as in the JAX package: a deterministic SMO
on kernel matrices from the exact chi-square distance (:func:`chi2_matrix`)
computed once.  K4m would not do here: its reciprocal is approximate, and
a grid search's accuracies tie often enough that a last-bit change in the
kernel can move its choice.  The model is plain arrays (``to_arrays`` /
``from_arrays``), saved in the JAX package's .ismd.npz keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


def chi2_matrix(a: np.ndarray, b: np.ndarray,
                chunk_elems: int = 1 << 24) -> np.ndarray:
    """flann::ChiSquareDistance matrix [A, B] on the host in float32 (terms
    with a_i + b_i <= 0 skipped), in row chunks of ~chunk_elems elements:
    the JAX ``chi_square_distance_np``."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    A, D = a.shape
    B = b.shape[0]
    out = np.empty((A, B), np.float32)
    rows = max(1, min(A, chunk_elems // max(B * D, 1)))
    for i0 in range(0, A, rows):
        ab = a[i0:i0 + rows, None, :]
        diff2 = (ab - b[None, :, :]) ** 2
        s = ab + b[None, :, :]
        out[i0:i0 + rows] = np.where(
            s > 0, diff2 / np.where(s > 0, s, 1.0), 0.0).sum(axis=2)
    return out


def smo_train(K: np.ndarray, y: np.ndarray, C: float, tol: float = 1e-3,
              max_passes: int = 5, max_iter: int = 2000, seed: int = 0
              ) -> Tuple[np.ndarray, float]:
    """Simplified SMO for the dual C-SVC.  K: [n, n] kernel, y in {-1, +1}.
    Returns (alphas, b) with decision f(x) = sum_i a_i y_i K(x_i, x) + b."""
    n = len(y)
    alphas = np.zeros(n)
    b = 0.0
    rng = np.random.default_rng(seed)
    passes = 0
    it = 0

    def f(i):
        return (alphas * y) @ K[:, i] + b

    while passes < max_passes and it < max_iter:
        it += 1
        num_changed = 0
        for i in range(n):
            Ei = f(i) - y[i]
            if (y[i] * Ei < -tol and alphas[i] < C) or (y[i] * Ei > tol and alphas[i] > 0):
                j = int(rng.integers(0, n - 1))
                if j >= i:
                    j += 1
                Ej = f(j) - y[j]
                ai_old, aj_old = alphas[i], alphas[j]
                if y[i] != y[j]:
                    L, H = max(0.0, aj_old - ai_old), min(C, C + aj_old - ai_old)
                else:
                    L, H = max(0.0, ai_old + aj_old - C), min(C, ai_old + aj_old)
                if L == H:
                    continue
                eta = 2 * K[i, j] - K[i, i] - K[j, j]
                if eta >= 0:
                    continue
                aj = aj_old - y[j] * (Ei - Ej) / eta
                aj = min(H, max(L, aj))
                if abs(aj - aj_old) < 1e-5:
                    continue
                ai = ai_old + y[i] * y[j] * (aj_old - aj)
                alphas[i], alphas[j] = ai, aj
                b1 = b - Ei - y[i] * (ai - ai_old) * K[i, i] - y[j] * (aj - aj_old) * K[i, j]
                b2 = b - Ej - y[i] * (ai - ai_old) * K[i, j] - y[j] * (aj - aj_old) * K[j, j]
                if 0 < ai < C:
                    b = b1
                elif 0 < aj < C:
                    b = b2
                else:
                    b = (b1 + b2) / 2
                num_changed += 1
        passes = passes + 1 if num_changed == 0 else 0
    return alphas, b


@dataclass
class BinarySVM:
    """One binary decision function over stored support data."""
    sv: np.ndarray          # [m, D] support vectors
    coeffs: np.ndarray      # [m] alpha_i * y_i
    b: float
    gamma: float

    def decision(self, x: np.ndarray) -> np.ndarray:
        """f(x) for a batch [Q, D]."""
        k = np.exp(-self.gamma * chi2_matrix(x, self.sv))
        return k @ self.coeffs + self.b


@dataclass
class SVMModel:
    """Either pairwise 1-vs-1 (one decision fn per class pair) or 1-vs-all
    (one binary model per class)."""
    mode: str                      # "pairwise" | "one_vs_all"
    classes: np.ndarray            # [n_classes] original labels
    binaries: List[BinarySVM] = field(default_factory=list)
    pairs: List[Tuple[int, int]] = field(default_factory=list)  # pairwise only

    def predict(self, x: np.ndarray) -> Tuple[int, float, np.ndarray]:
        """Returns (label, score, all_scores) with predictUnifyScore
        semantics: higher = better for both modes."""
        nc = len(self.classes)
        if self.mode == "one_vs_all":
            # reference raw score: negative = recognized; our decision f is
            # positive for the target class, so score_ref = -f
            f = np.array([float(svm.decision(x[None] if x.ndim == 1 else x)[0])
                          for svm in self.binaries])
            scores_ref = -f
            label_idx = int(np.argmin(scores_ref))
            all_scores = (scores_ref * -1 + 1) * 0.5  # custom_SVM.cpp:312-317
            return int(self.classes[label_idx]), float(all_scores[label_idx]), all_scores
        # pairwise
        votes = np.zeros(nc, int)
        sums_of_sigmoids = np.zeros(nc)
        xq = x[None] if x.ndim == 1 else x
        for (i, j), svm in zip(self.pairs, self.binaries):
            s = float(svm.decision(xq)[0])
            if s > 0:
                votes[i] += 1
            else:
                votes[j] += 1
            sums_of_sigmoids[i] += 1.0 / (1.0 + np.exp(-s))
            sums_of_sigmoids[j] += 1.0 / (1.0 + np.exp(s))
        label_idx = int(np.argmax(votes))
        all_scores = sums_of_sigmoids / max(nc - 1, 1)
        return int(self.classes[label_idx]), float(all_scores[label_idx]), all_scores

    # -- persistence (plain arrays for npz) ---------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        out = {"svm_mode": np.array(self.mode), "svm_classes": self.classes}
        out["svm_count"] = np.array(len(self.binaries))
        if self.pairs:
            out["svm_pairs"] = np.array(self.pairs, np.int32)
        for i, bsvm in enumerate(self.binaries):
            out[f"svm_{i}_sv"] = bsvm.sv
            out[f"svm_{i}_coeffs"] = bsvm.coeffs
            out[f"svm_{i}_meta"] = np.array([bsvm.b, bsvm.gamma], np.float64)
        return out

    @classmethod
    def from_arrays(cls, z) -> Optional["SVMModel"]:
        if "svm_mode" not in getattr(z, "files", []):
            return None
        model = cls(mode=str(z["svm_mode"]), classes=z["svm_classes"])
        if "svm_pairs" in z.files:
            model.pairs = [tuple(p) for p in z["svm_pairs"]]
        for i in range(int(z["svm_count"])):
            b, gamma = z[f"svm_{i}_meta"]
            model.binaries.append(BinarySVM(
                sv=z[f"svm_{i}_sv"], coeffs=z[f"svm_{i}_coeffs"],
                b=float(b), gamma=float(gamma)))
        return model


def _train_binary(chi2: np.ndarray, data: np.ndarray, y: np.ndarray,
                  C: float, gamma: float) -> BinarySVM:
    K = np.exp(-gamma * chi2)
    alphas, b = smo_train(K, y.astype(np.float64), C)
    sv_mask = alphas > 1e-8
    return BinarySVM(sv=data[sv_mask].astype(np.float32),
                     coeffs=(alphas * y)[sv_mask], b=float(b), gamma=gamma)


def _cv_accuracy(chi2: np.ndarray, data: np.ndarray, y: np.ndarray,
                 C: float, gamma: float, k_fold: int) -> float:
    n = len(y)
    k_fold = max(2, min(k_fold, n))
    folds = np.arange(n) % k_fold
    correct = 0
    for f in range(k_fold):
        tr = folds != f
        te = ~tr
        if tr.sum() == 0 or te.sum() == 0:
            continue
        K_tr = np.exp(-gamma * chi2[np.ix_(tr, tr)])
        alphas, b = smo_train(K_tr, y[tr].astype(np.float64), C,
                              max_passes=3, max_iter=500)
        K_te = np.exp(-gamma * chi2[np.ix_(te, tr)])
        f_te = K_te @ (alphas * y[tr]) + b
        correct += int(((f_te > 0) == (y[te] > 0)).sum())
    return correct / n


def _geom_grid(lo: float, hi: float, step: float) -> List[float]:
    vals = []
    v = lo
    while v <= hi * (1 + 1e-9):
        vals.append(v)
        v *= step
    return vals


def train_svm(
    data: np.ndarray,      # [n, D] global descriptors
    labels: np.ndarray,    # [n] class ids
    one_vs_all: bool,
    auto_train: bool,
    param_c: float = 7.41,
    param_gamma: float = 2.96,
    k_fold: int = 10,
) -> SVMModel:
    """trainSimple / trainAutomatically (custom_SVM.cpp:107-284)."""
    classes = np.unique(labels)
    chi2 = chi2_matrix(data, data)

    def pick_params(y: np.ndarray) -> Tuple[float, float]:
        if not auto_train:
            return param_c, param_gamma
        big = len(data) > 1000
        c_grid = _geom_grid(0.001 if big else 1e-5, 1000 if big else 4096,
                            10 if big else 2)
        g_grid = _geom_grid(1e-4 if big else 1e-6, 10 if big else 8,
                            10 if big else np.sqrt(2))
        best = (param_c, param_gamma, -1.0)
        for C in c_grid:
            for g in g_grid:
                acc = _cv_accuracy(chi2, data, y, C, g, k_fold)
                if acc > best[2]:
                    best = (C, g, acc)
        # refined grid around the winner (custom_SVM.cpp:233-270)
        c_step = 10 if big else 2
        g_step = 10 if big else np.sqrt(2)
        c_fine = _geom_grid(max(best[0] / c_step**2, 1e-5),
                            best[0] * c_step**2, np.sqrt(c_step))
        g_fine = _geom_grid(max(best[1] / g_step**2, 1e-4),
                            best[1] * g_step**2, np.sqrt(g_step))
        for C in c_fine:
            for g in g_fine:
                acc = _cv_accuracy(chi2, data, y, C, g, k_fold)
                if acc > best[2]:
                    best = (C, g, acc)
        return best[0], best[1]

    if one_vs_all:
        model = SVMModel(mode="one_vs_all", classes=classes)
        for cls in classes:
            y = np.where(labels == cls, 1.0, -1.0)
            C, g = pick_params(y)
            model.binaries.append(_train_binary(chi2, data, y, C, g))
        return model

    model = SVMModel(mode="pairwise", classes=classes)
    for i in range(len(classes)):
        for j in range(i + 1, len(classes)):
            sel = (labels == classes[i]) | (labels == classes[j])
            y = np.where(labels[sel] == classes[i], 1.0, -1.0)
            sub_chi2 = chi2[np.ix_(sel, sel)]
            if auto_train:
                # grid on the pair's subproblem
                sub_data = data[sel]
                saved = chi2
                try:
                    C, g = param_c, param_gamma
                    best = (C, g, -1.0)
                    for Cv in _geom_grid(1e-3, 100, 10):
                        for gv in _geom_grid(1e-3, 10, np.sqrt(10)):
                            acc = _cv_accuracy(sub_chi2, sub_data, y, Cv, gv, k_fold)
                            if acc > best[2]:
                                best = (Cv, gv, acc)
                    C, g = best[0], best[1]
                finally:
                    chi2 = saved
            else:
                C, g = param_c, param_gamma
            K = np.exp(-g * sub_chi2)
            alphas, b = smo_train(K, y, C)
            sv_mask = alphas > 1e-8
            model.pairs.append((i, j))
            model.binaries.append(BinarySVM(
                sv=data[sel][sv_mask].astype(np.float32),
                coeffs=(alphas * y)[sv_mask], b=float(b), gamma=g))
    return model
