"""Hyper-parameter tuning (port of ``recbole_gnn_tpu/hyper.py``;
reference: run_hyper.py + [recbole] HyperTuning): exhaustive grid,
seeded random search and a TPE-style "bayes" search, each over the
port's ``objective_function``.  The search's randomness is numpy
``default_rng(seed)``, so it draws the same parameter sets in the same
order as the JAX package.

Params-file format (one line per hyperparameter, [recbole] style):
    learning_rate choice [0.01,0.005,0.001]
    n_layers choice [1,2,3]
    reg_weight loguniform [1e-5, 1e-2]
For exhaustive search ``uniform``/``loguniform`` lines are sampled on a
small fixed grid; ``random`` draws them continuously (seeded).
"""

from __future__ import annotations

import itertools

import numpy as np
import yaml

from recbole_gnn_tpu_torch.quick_start import objective_function


def parse_params_file_raw(path: str) -> dict[str, tuple]:
    """{name: (kind, payload)} — choice keeps its value list,
    uniform/loguniform keep their (lo, hi) bounds."""
    space: dict[str, tuple] = {}
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, kind, rest = line.split(None, 2)
            if kind == "choice":
                space[name] = ("choice", list(yaml.safe_load(rest)))
            elif kind in ("uniform", "loguniform"):
                loaded = yaml.safe_load(rest)
                if isinstance(loaded, list):
                    lo, hi = float(loaded[0]), float(loaded[1])
                else:
                    parts = rest.replace(",", " ").split()
                    lo, hi = float(parts[0]), float(parts[1])
                space[name] = (kind, (lo, hi))
            else:
                raise ValueError(f"unknown space kind {kind!r}")
    return space


def _gridded(raw: dict[str, tuple]) -> dict[str, list]:
    grid: dict[str, list] = {}
    for name, (kind, payload) in raw.items():
        if kind == "choice":
            grid[name] = list(payload)
        elif kind == "uniform":
            grid[name] = list(np.linspace(*payload, 5))
        else:
            lo, hi = payload
            grid[name] = list(np.logspace(np.log10(lo), np.log10(hi), 5))
    return grid


def parse_params_file(path: str) -> dict[str, list]:
    return _gridded(parse_params_file_raw(path))


class HyperTuning:
    """Exhaustive grid / seeded random search with result export."""

    def __init__(self, objective=objective_function, algo: str = "exhaustive",
                 params_file: str | None = None,
                 space: dict[str, list] | None = None,
                 fixed_config_file_list: list[str] | None = None,
                 fixed_config_dict: dict | None = None,
                 max_evals: int = 30, seed: int = 2020):
        if algo not in ("exhaustive", "random", "bayes"):
            raise ValueError(
                f"algo must be 'exhaustive', 'random' or 'bayes', "
                f"got {algo!r}")
        self.algo = algo
        self.max_evals = int(max_evals)
        self.seed = int(seed)
        self.objective = objective
        if space is not None:
            self.raw_space = {k: ("choice", list(v))
                              for k, v in space.items()}
        else:
            self.raw_space = parse_params_file_raw(params_file)
        self.space = _gridded(self.raw_space)
        self.fixed_config_file_list = fixed_config_file_list
        self.fixed_config_dict = dict(fixed_config_dict or {})
        self.params2result: dict[str, dict] = {}
        self.best_params: dict | None = None
        self.best_score: float | None = None
        self.best_result: dict | None = None

    def _iter_param_sets(self):
        names = sorted(self.space.keys())
        if self.algo == "exhaustive":
            for combo in itertools.product(
                    *(self.space[n] for n in names)):
                yield dict(zip(names, combo))
            return
        rng = np.random.default_rng(self.seed)
        seen: set[str] = set()
        # duplicate draws do NOT consume evaluation budget: loop until
        # max_evals UNIQUE sets are yielded (small all-choice spaces
        # collide often), with a bounded retry cap so an exhausted
        # space (fewer unique combos than max_evals) still terminates
        yielded = 0
        attempts = 0
        max_attempts = max(100, 50 * self.max_evals)
        while yielded < self.max_evals and attempts < max_attempts:
            attempts += 1
            params = {}
            for n in names:
                kind, payload = self.raw_space[n]
                if kind == "choice":
                    params[n] = payload[rng.integers(len(payload))]
                elif kind == "uniform":
                    params[n] = float(rng.uniform(*payload))
                else:   # loguniform
                    lo, hi = np.log(payload[0]), np.log(payload[1])
                    params[n] = float(np.exp(rng.uniform(lo, hi)))
            key = str(params)
            if key in seen:
                continue
            seen.add(key)
            yielded += 1
            yield params

    def _evaluate(self, params):
        cfg = dict(self.fixed_config_dict)
        cfg.update(params)
        result = self.objective(
            config_dict=cfg,
            config_file_list=self.fixed_config_file_list, saved=False)
        key = str(params)
        self.params2result[key] = result
        score = result["best_valid_score"]
        bigger = result.get("valid_score_bigger", True)
        better = (self.best_score is None or
                  (score > self.best_score if bigger
                   else score < self.best_score))
        if better:
            self.best_score = score
            self.best_params = params
            self.best_result = result
        return float(score), bigger

    # -- bayes (TPE-style) ------------------------------------------------

    def _sample_prior(self, rng) -> dict:
        params = {}
        for n in sorted(self.raw_space):
            kind, payload = self.raw_space[n]
            if kind == "choice":
                params[n] = payload[rng.integers(len(payload))]
            elif kind == "uniform":
                params[n] = float(rng.uniform(*payload))
            else:
                lo, hi = np.log(payload[0]), np.log(payload[1])
                params[n] = float(np.exp(rng.uniform(lo, hi)))
        return params

    def _tpe_logratio(self, cand: dict, good: list[dict],
                      bad: list[dict]) -> float:
        """log P(x|good) − log P(x|bad): per-dimension naive product —
        categorical counts with Laplace smoothing; 1-D Gaussian KDE
        (log-space for loguniform) for continuous dims."""
        s = 0.0
        for n, (kind, payload) in self.raw_space.items():
            xv = cand[n]
            if kind == "choice":
                k = len(payload)
                cg = sum(1 for p in good if p[n] == xv)
                cb = sum(1 for p in bad if p[n] == xv)
                s += (np.log((cg + 1.0) / (len(good) + k))
                      - np.log((cb + 1.0) / (len(bad) + k)))
            else:
                lo, hi = payload
                tf = (lambda v: np.log(v)) if kind == "loguniform" else \
                    (lambda v: v)
                span = abs(tf(hi) - tf(lo)) or 1.0
                x = tf(xv)

                def log_kde(obs):
                    if not obs:
                        return -np.log(span)   # uniform prior density
                    xs = np.array([tf(p[n]) for p in obs])
                    bw = max(float(np.std(xs)) * len(xs) ** -0.2,
                             span / 20.0)
                    z = (x - xs) / bw
                    dens = float(np.mean(np.exp(-0.5 * z * z))) \
                        / (bw * np.sqrt(2 * np.pi))
                    return np.log(dens + 1e-12)

                s += log_kde(good) - log_kde(bad)
        return float(s)

    def _run_bayes(self):
        """TPE-style sequential search ([recbole] HyperTuning offers a
        hyperopt 'bayes' algo; this is the dependency-free analog):
        after n_startup random draws, split
        observations at the γ=25% quantile into good/bad, draw
        candidates from the prior and evaluate the one maximizing the
        good/bad density ratio."""
        rng = np.random.default_rng(self.seed)
        obs: list[tuple[dict, float]] = []
        bigger = True
        seen: set[str] = set()
        n_startup = min(5, self.max_evals)
        while len(obs) < self.max_evals:
            if len(obs) < n_startup:
                # bounded de-dup: a small all-discrete space can have
                # fewer unique combos than n_startup — after
                # max_attempts collisions, accept the duplicate draw
                # (mirrors the 'random' algo's guard) so the loop
                # always terminates
                cand = self._sample_prior(rng)
                for _ in range(64):
                    if str(cand) not in seen:
                        break
                    cand = self._sample_prior(rng)
            else:
                srt = sorted(obs, key=lambda t: -t[1] if bigger else t[1])
                n_good = max(1, int(np.ceil(0.25 * len(srt))))
                good = [p for p, _ in srt[:n_good]]
                bad = [p for p, _ in srt[n_good:]]
                pool = [self._sample_prior(rng) for _ in range(24)]
                pool = [c for c in pool if str(c) not in seen] or pool
                cand = max(pool,
                           key=lambda c: self._tpe_logratio(c, good, bad))
            seen.add(str(cand))
            score, bigger = self._evaluate(cand)
            obs.append((cand, score))
        return self.best_params, self.best_result

    def run(self):
        if self.algo == "bayes":
            return self._run_bayes()
        for params in self._iter_param_sets():
            self._evaluate(params)
        return self.best_params, self.best_result

    def export_result(self, output_file: str):
        with open(output_file, "w", encoding="utf-8") as f:
            for params, result in self.params2result.items():
                f.write(f"{params}\n")
                f.write(f"Valid result:\n{result['best_valid_result']}\n")
                f.write(f"Test result:\n{result['test_result']}\n\n")
