"""Hyperparameter-search engine with an optuna-compatible surface.

Counterpart of ``motionmixerconv_tpu/sweep/engine.py``, identical in its
samplers, pruner and sqlite schema, so one ``results.db`` is read and
continued by either package; only the placement of ``optimize(devices=)``
differs (torch devices, below). Pure Python, numpy and ``sqlite3``:
``trials_dataframe`` imports pandas when called, and the ``optuna``
backend imports optuna when asked for.

The reference drives its studies with optuna (BruteForceSampler + sqlite
storage, conv_optuna_main.py:371-406). optuna is not a baked-in dependency
of this environment, so this module provides a small native engine exposing
the same objective-side API — ``trial.suggest_int/float/categorical``,
``trial.set_user_attr``, ``trial.report`` + ``trial.should_prune`` (with
``MedianPruner``) — with sqlite persistence and grid (brute-force) or
random sampling. When optuna *is* installed, ``create_study(backend="optuna")``
returns a real optuna study instead; objectives written against this module
run unchanged on either.
"""

from __future__ import annotations

import contextlib
import json
import os
import sqlite3
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence


class TrialPruned(Exception):
    pass


@dataclass
class Trial:
    """optuna.Trial-compatible parameter-suggestion interface."""

    number: int
    _sampler: "Sampler"
    params: dict = field(default_factory=dict)
    user_attrs: dict = field(default_factory=dict)
    intermediate_values: dict = field(default_factory=dict)
    # study lock guarding sampler state under optimize(n_jobs>1); samplers
    # mutate shared state (grid discovery, TPE history, the random stream)
    _lock: Any = None
    _study: Any = None  # owning Study; needed by should_prune()
    _fixed: Any = None  # params pinned by Study.enqueue_trial
    # the torch device optimize(devices=) placed this trial on (None
    # without devices); the study objectives train on it (args.dev)
    device: Any = None

    def _suggest(self, name: str, choices: Sequence[Any]) -> Any:
        if self._fixed and name in self._fixed:
            value = self._fixed[name]
            # the sampler still learns the space (grid decode, TPE history)
            with self._lock or contextlib.nullcontext():
                self._sampler.register_space(name, list(choices))
        else:
            with self._lock or contextlib.nullcontext():
                value = self._sampler.sample(self.number, name, list(choices))
        self.params[name] = value
        return value

    def suggest_int(self, name: str, low: int, high: int, step: int = 1) -> int:
        return int(self._suggest(name, list(range(low, high + 1, step))))

    def suggest_float(self, name: str, low: float, high: float,
                      step: Optional[float] = None, log: bool = False) -> float:
        if step is not None:
            n = int(round((high - low) / step)) + 1
            return float(self._suggest(name, [low + i * step for i in range(n)]))
        # continuous: grid sampler quantizes to 10 points; random is uniform
        return float(self._suggest(name, _continuous(low, high, log)))

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._suggest(name, choices)

    def set_user_attr(self, key: str, value: Any) -> None:
        self.user_attrs[key] = value

    def report(self, value: float, step: int) -> None:
        """Record an intermediate objective value (optuna.Trial.report)."""
        self.intermediate_values[int(step)] = float(value)

    def should_prune(self) -> bool:
        """Ask the study's pruner about the latest reported step; the
        caller raises TrialPruned (optuna's if-should-prune-raise idiom)."""
        study = self._study
        if study is None or study.pruner is None:
            return False
        with self._lock or contextlib.nullcontext():
            return study.pruner.prune(study, self)


def _continuous(low, high, log):
    import numpy as np

    if log:
        return list(np.geomspace(low, high, 10))
    return list(np.linspace(low, high, 10))


class Sampler:
    def sample(self, trial_number: int, name: str, choices: list) -> Any:
        raise NotImplementedError

    def register_space(self, name: str, choices: list) -> None:
        pass


class GridSampler(Sampler):
    """Brute-force grid over the cartesian product of every suggested space.

    Equivalent to optuna.samplers.BruteForceSampler for a fixed search space
    (conv_optuna_main.py:382): the grid is discovered from the first trial's
    suggestions and enumerated in suggestion order.
    """

    def __init__(self):
        self._spaces: dict[str, list] = {}
        self._order: list[str] = []

    def preload(self, order: list, spaces: dict) -> None:
        """Restore a previously persisted search space (study resume)."""
        self._order = list(order)
        self._spaces = {k: list(v) for k, v in spaces.items()}

    def register_space(self, name: str, choices: list) -> None:
        if name not in self._spaces:
            self._spaces[name] = list(choices)
            self._order.append(name)

    def sample(self, trial_number: int, name: str, choices: list) -> Any:
        self.register_space(name, choices)
        sizes = [len(self._spaces[k]) for k in self._order]
        idx = trial_number
        # mixed-radix decode, last-suggested parameter varies fastest
        coords = {}
        for k, size in zip(reversed(self._order), reversed(sizes)):
            coords[k] = idx % size
            idx //= size
        return self._spaces[name][coords[name] % len(self._spaces[name])]

    def n_points(self) -> Optional[int]:
        if not self._spaces:
            return None
        n = 1
        for v in self._spaces.values():
            n *= len(v)
        return n


class RandomSampler(Sampler):
    def __init__(self, seed: int = 0):
        import numpy as np

        self._rng = np.random.RandomState(seed)

    def sample(self, trial_number: int, name: str, choices: list) -> Any:
        return choices[int(self._rng.randint(len(choices)))]


@dataclass
class FrozenTrial:
    number: int
    state: str
    values: Optional[list]
    params: dict
    user_attrs: dict
    intermediate_values: dict = field(default_factory=dict)


class MedianPruner:
    """optuna.pruners.MedianPruner semantics: prune when the trial's RUNNING
    BEST intermediate value up to step s is worse than the median of COMPLETE
    trials' values AT exactly step s. The asymmetry is optuna's
    (PercentilePruner: `_get_best_intermediate_result_over_steps` for the
    current trial, `t.intermediate_values[step]` for peers — peers with no
    report at step s are excluded). ``n_startup_trials`` completed trials
    are required before any pruning; steps below ``n_warmup_steps`` never
    prune; only every ``interval_steps``-th step past warmup is checked; a
    NaN report always prunes.
    """

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0,
                 interval_steps: int = 1):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps
        self.interval_steps = max(1, interval_steps)

    def prune(self, study: "Study", trial: Trial) -> bool:
        import math

        if not trial.intermediate_values:
            return False
        step = max(trial.intermediate_values)
        if math.isnan(trial.intermediate_values[step]):
            return True  # a diverged trial is always prunable (optuna too)
        if step < self.n_warmup_steps:
            return False
        if (step - self.n_warmup_steps) % self.interval_steps:
            return False
        done = [t for t in study.trials if t.state == "COMPLETE"]
        if len(done) < self.n_startup_trials:
            return False

        maximize = study.directions[0] == "maximize"

        def running_best(iv: dict) -> Optional[float]:
            vals = [v for s, v in iv.items()
                    if s <= step and not math.isnan(v)]
            if not vals:
                return None
            return max(vals) if maximize else min(vals)

        value = running_best(trial.intermediate_values)
        if value is None:
            return False
        peers = sorted(
            t.intermediate_values[step] for t in done
            if step in t.intermediate_values
            and not math.isnan(t.intermediate_values[step])
        )
        if not peers:
            return False
        n = len(peers)
        median = (peers[n // 2] if n % 2
                  else 0.5 * (peers[n // 2 - 1] + peers[n // 2]))
        if study.directions[0] == "maximize":
            return value < median
        return value > median


class Study:
    """Minimal study: sequential trials, sqlite persistence, multi-objective."""

    def __init__(self, study_name: str, storage: Optional[str] = None,
                 sampler: Optional[Sampler] = None,
                 directions: Sequence[str] = ("minimize",),
                 pruner: Optional[MedianPruner] = None):
        self.study_name = study_name
        self.sampler = sampler or GridSampler()
        self.directions = list(directions)
        self.pruner = pruner
        self.user_attrs: dict = {}
        self._queued: list[dict] = []  # enqueue_trial FIFO
        self._lock = threading.RLock()  # guards trials/sampler/sqlite under n_jobs>1
        self._conn = None
        if storage:
            path = storage.replace("sqlite:///", "")
            # check_same_thread=False: optimize(n_jobs>1) records trials
            # from worker threads; every use is serialized by self._lock
            self._conn = sqlite3.connect(path, check_same_thread=False)
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS trials ("
                "study TEXT, number INTEGER, state TEXT, values_json TEXT, "
                "params_json TEXT, user_attrs_json TEXT, t REAL)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS spaces ("
                "study TEXT, ord INTEGER, name TEXT, choices_json TEXT)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS intermediates ("
                "study TEXT, number INTEGER, step INTEGER, value REAL)"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS study_attrs ("
                "study TEXT, key TEXT, value_json TEXT)"
            )
            self._conn.commit()
        self.trials: list[FrozenTrial] = []
        if self._conn is not None:
            # restore the grid sampler's discovered space so resumed studies
            # decode trial numbers against the FULL grid (not a partial one,
            # which would duplicate some points and skip others)
            srows = self._conn.execute(
                "SELECT ord, name, choices_json FROM spaces WHERE study=? "
                "ORDER BY ord", (study_name,)
            ).fetchall()
            if srows and hasattr(self.sampler, "preload"):
                order = [r[1] for r in srows]
                spaces = {r[1]: json.loads(r[2]) for r in srows}
                self.sampler.preload(order, spaces)
            rows = self._conn.execute(
                "SELECT number, state, values_json, params_json, user_attrs_json "
                "FROM trials WHERE study=? ORDER BY number", (study_name,)
            ).fetchall()
            irows = self._conn.execute(
                "SELECT number, step, value FROM intermediates WHERE study=?",
                (study_name,)
            ).fetchall()
            inter: dict[int, dict] = {}
            for num, step, value in irows:
                inter.setdefault(num, {})[step] = value
            for num, st, vals, params, attrs in rows:
                ft = FrozenTrial(
                    num, st, json.loads(vals) if vals else None,
                    json.loads(params), json.loads(attrs),
                    inter.get(num, {}),
                )
                self.trials.append(ft)
                if ft.state == "COMPLETE" and ft.values and hasattr(self.sampler, "observe"):
                    self.sampler.observe(ft.params, ft.values, self.directions)
            for key, vj in self._conn.execute(
                    "SELECT key, value_json FROM study_attrs WHERE study=?",
                    (study_name,)):
                self.user_attrs[key] = json.loads(vj)
        # max+1, NOT len: n_jobs>1 / ask() can leave gaps in the recorded
        # numbers (a killed run, an ask never told) and len() would reissue
        # the tail numbers, duplicating trials and grid points on resume
        self._next_number = max(
            (t.number for t in self.trials), default=-1) + 1

    @staticmethod
    def _json_default(o):
        """numpy scalars/arrays in user_attrs -> native JSON types."""
        if hasattr(o, "item"):
            return o.item()
        if hasattr(o, "tolist"):
            return o.tolist()
        raise TypeError(f"Object of type {type(o).__name__} is not JSON serializable")

    def _record(self, trial: Trial, state: str, values: Optional[list]):
        frozen = FrozenTrial(trial.number, state, values, trial.params,
                             trial.user_attrs, dict(trial.intermediate_values))
        with self._lock:
            self.trials.append(frozen)
            if state == "COMPLETE" and values and hasattr(self.sampler, "observe"):
                self.sampler.observe(trial.params, values, self.directions)
            if self._conn is not None:
                self._conn.execute(
                    "INSERT INTO trials VALUES (?,?,?,?,?,?,?)",
                    (self.study_name, trial.number, state,
                     json.dumps(values, default=self._json_default),
                     json.dumps(trial.params, default=self._json_default),
                     json.dumps(trial.user_attrs, default=self._json_default),
                     time.time()),
                )
                self._conn.executemany(
                    "INSERT INTO intermediates VALUES (?,?,?,?)",
                    [(self.study_name, trial.number, s, v)
                     for s, v in sorted(trial.intermediate_values.items())],
                )
                self._conn.commit()
            self._persist_spaces()

    def _persist_spaces(self):
        """Record the sampler's (grid) space as it is discovered."""
        if self._conn is None or not isinstance(self.sampler, GridSampler):
            return
        known = {
            r[0] for r in self._conn.execute(
                "SELECT name FROM spaces WHERE study=?", (self.study_name,)
            ).fetchall()
        }
        for i, name in enumerate(self.sampler._order):
            if name not in known:
                self._conn.execute(
                    "INSERT INTO spaces VALUES (?,?,?,?)",
                    (self.study_name, i, name,
                     json.dumps(self.sampler._spaces[name],
                                default=self._json_default)),
                )
        self._conn.commit()

    def optimize(self, objective: Callable[[Trial], Any],
                 n_trials: int = 40, timeout: Optional[float] = None,
                 catch: tuple = (), n_jobs: int = 1,
                 devices: Optional[Sequence[Any]] = None) -> None:
        """Run trials; ``n_jobs>1`` runs them on a thread pool (optuna's
        n_jobs semantics — objectives must be thread-safe; the studies
        isolate per-trial logdirs by trial number). Whether a
        second concurrent trial helps on one card is measured, not assumed
        (``PERF.md`` §5: the JAX package's claim that concurrent trials
        overlap host work with device execution was reasoned for a TPU).
        Parallel runs are NOT run-to-run reproducible for random/TPE
        samplers (trial->draw assignment depends on thread timing), same
        as optuna.

        ``devices``: optional sequence of ``torch.device``s; trial ``i``
        runs on ``devices[i % len(devices)]`` -- deterministic round-robin
        placement regardless of which worker thread picks the trial up.
        The objective sees it as ``trial.device`` (the studies train
        on it through ``args.dev``: the port's trainers take their device
        from their arguments, and ``torch.cuda.device`` alone moves
        nothing). On a CUDA device the trial also runs with that device
        current and on a stream of its own, off the legacy default stream,
        so concurrent trials on one card share no stream
        (``train/graphs.py``). When ``devices`` is given and ``n_jobs`` is
        left at 1, ``n_jobs`` defaults to ``len(devices)`` -- one worker
        per device.
        """
        if devices is not None and len(devices) == 0:
            raise ValueError("devices must be a non-empty sequence")
        if devices is not None and n_jobs == 1:
            n_jobs = len(devices)

        def placement(trial: Trial):
            if devices is None:
                return contextlib.nullcontext()
            import torch  # deferred: the engine itself needs no torch

            trial.device = torch.device(devices[trial.number % len(devices)])
            if trial.device.type != "cuda":
                return contextlib.nullcontext()
            stack = contextlib.ExitStack()
            stack.enter_context(torch.cuda.device(trial.device))
            stack.enter_context(torch.cuda.stream(
                torch.cuda.Stream(trial.device)))
            return stack

        t0 = time.time()
        state = {"issued": 0}
        # first uncaught objective error; also a stop signal: the surviving
        # workers must not keep burning trials after one worker died (the
        # sequential path, and optuna, stop at the first uncaught error)
        errors: list[BaseException] = []

        def next_trial() -> Optional[Trial]:
            with self._lock:
                if errors:
                    return None
                if state["issued"] >= n_trials:
                    return None
                if timeout is not None and time.time() - t0 > timeout:
                    return None
                if (isinstance(self.sampler, GridSampler)
                        and not self._queued):
                    n_pts = self.sampler.n_points()
                    if n_pts is not None and self._next_number >= n_pts:
                        return None  # grid exhausted
                state["issued"] += 1
                return self.ask()

        def run_one(trial: Trial) -> None:
            try:
                with placement(trial):
                    result = objective(trial)
            except TrialPruned:
                self._record(trial, "PRUNED", None)
                return
            except catch as e:  # reference: catch=(Exception,) (:405)
                print(f"trial {trial.number} failed: {e}")
                self._record(trial, "FAIL", None)
                return
            except BaseException:
                # uncaught objective error: record the trial as FAIL before
                # propagating (optuna does the same), so a sqlite resume
                # sees a contiguous trial-number sequence — under n_jobs>1
                # higher-numbered concurrent trials may still complete, and
                # an unrecorded crash would make max+1 skip this grid point
                self._record(trial, "FAIL", None)
                raise
            try:
                values = (list(result) if isinstance(result, (tuple, list))
                          else [result])
                values = [float(v) for v in values]
            except BaseException:
                # a non-numeric objective return (None, str, ...) is an
                # uncaught objective error too: record FAIL before
                # propagating, or a sqlite resume's max+1 would skip this
                # grid point forever (same invariant as the except above)
                self._record(trial, "FAIL", None)
                raise
            self._record(trial, "COMPLETE", values)

        if n_jobs is None or n_jobs == 1:
            while (trial := next_trial()) is not None:
                run_one(trial)
            return

        if n_jobs < 0:  # optuna: -1 = one worker per CPU
            n_jobs = os.cpu_count() or 1

        # With an undiscovered grid space the FIRST trial must run alone:
        # the mixed-radix decode needs the full space before any concurrent
        # trial samples, or grid points would repeat/skip.
        if isinstance(self.sampler, GridSampler) and not self.sampler._order:
            trial = next_trial()
            if trial is None:
                return
            run_one(trial)

        def worker():
            try:
                while (trial := next_trial()) is not None:
                    run_one(trial)
            except BaseException as e:
                with self._lock:
                    errors.append(e)

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(n_jobs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def ask(self) -> Trial:
        """Hand out the next trial (optuna's ask half of ask-and-tell).

        The trial draws from the study's sampler on each ``suggest_*`` call;
        params pinned by ``enqueue_trial`` take precedence. Complete it with
        ``tell``. Thread-safe with a concurrent ``optimize``: both draw
        numbers from one counter.
        """
        with self._lock:
            number = self._next_number
            self._next_number += 1
            fixed = self._queued.pop(0) if self._queued else None
            return Trial(number=number, _sampler=self.sampler,
                         _lock=self._lock, _study=self, _fixed=fixed)

    def tell(self, trial: Trial, values=None, state: str = "COMPLETE") -> None:
        """Record an ask()'d trial (optuna's tell half).

        values: scalar or sequence for COMPLETE trials; ignored for
        PRUNED/FAIL. The sampler observes COMPLETE results exactly as under
        ``optimize``.
        """
        if state not in ("COMPLETE", "PRUNED", "FAIL"):
            raise ValueError(f"unknown trial state {state!r}")
        if state == "COMPLETE":
            if values is None:
                raise ValueError("COMPLETE trial needs values")
            vs = (list(values) if isinstance(values, (tuple, list))
                  else [values])
            self._record(trial, state, [float(v) for v in vs])
        else:
            self._record(trial, state, None)

    def enqueue_trial(self, params: dict) -> None:
        """Pin the next trial's parameters (optuna.Study.enqueue_trial) —
        warm-starting a search from known-good configurations. Names not in
        ``params`` are still drawn from the sampler. With a GridSampler the
        enqueued trial consumes its trial-number's grid point (numbers
        drive the mixed-radix decode), like a failed trial does.
        """
        with self._lock:
            self._queued.append(dict(params))

    def set_user_attr(self, key: str, value: Any) -> None:
        """Study-level attribute, persisted alongside the trials."""
        with self._lock:
            self.user_attrs[key] = value
            if self._conn is not None:
                self._conn.execute(
                    "DELETE FROM study_attrs WHERE study=? AND key=?",
                    (self.study_name, key))
                self._conn.execute(
                    "INSERT INTO study_attrs VALUES (?,?,?)",
                    (self.study_name, key,
                     json.dumps(value, default=self._json_default)))
                self._conn.commit()

    @property
    def best_trial(self) -> FrozenTrial:
        done = [t for t in self.trials if t.state == "COMPLETE"]
        if not done:
            raise ValueError("no completed trials")
        sign = -1.0 if self.directions[0] == "maximize" else 1.0
        return min(done, key=lambda t: sign * t.values[0])

    @property
    def best_trials(self) -> list:
        """Pareto-optimal COMPLETE trials (optuna.Study.best_trials).

        For a single objective this is every trial tied with the best; for
        the two-objective studies (conv/autoreg h36m) the non-dominated
        front over (mpjpe, angle).
        """
        done = [t for t in self.trials if t.state == "COMPLETE" and t.values]
        signs = [1.0 if d == "minimize" else -1.0 for d in self.directions]

        def adj(t):
            return [s * v for s, v in zip(signs, t.values)]

        def dominates(a, b):
            return (all(x <= y for x, y in zip(a, b))
                    and any(x < y for x, y in zip(a, b)))

        fronts = []
        for t in done:
            at = adj(t)
            if not any(dominates(adj(u), at) for u in done if u is not t):
                fronts.append(t)
        return fronts

    def trials_dataframe(self):
        import pandas as pd

        rows = []
        for t in self.trials:
            row = {"number": t.number, "state": t.state}
            if t.values:
                for i, v in enumerate(t.values):
                    row[f"values_{i}"] = v
            row.update({f"params_{k}": v for k, v in t.params.items()})
            row.update({f"user_attrs_{k}": v for k, v in t.user_attrs.items()})
            rows.append(row)
        return pd.DataFrame(rows)


def create_study(study_name: str, storage: Optional[str] = None,
                 sampler: Optional[Sampler] = None,
                 directions: Sequence[str] = ("minimize",),
                 backend: str = "auto", pruner=None):
    """Create a study; backend='optuna' returns a real optuna study."""
    if backend == "optuna":
        if isinstance(pruner, MedianPruner):
            # the native pruner compares FrozenTrial state STRINGS; inside a
            # real optuna study every comparison fails silently and nothing
            # is ever pruned — refuse rather than disable pruning quietly
            raise ValueError(
                "backend='optuna' needs an optuna pruner "
                "(optuna.pruners.MedianPruner), not the native MedianPruner"
            )
        import optuna

        return optuna.create_study(
            study_name=study_name, storage=storage,
            directions=list(directions), load_if_exists=True,
            pruner=pruner,
        )
    return Study(study_name, storage=storage, sampler=sampler,
                 directions=directions, pruner=pruner)


class TPESampler(Sampler):
    """Independent Tree-structured Parzen Estimator sampler.

    Capability parity with the reference MlpMixer study's default optuna TPE
    (optuna_search/optuna_main.py:168-191): after ``n_startup`` random trials,
    each parameter is sampled by splitting past observations into good/bad at
    the gamma-quantile of the (first) objective, fitting Gaussian KDEs l(x)
    and g(x), and choosing the candidate maximizing l(x)/g(x). Parameters are
    modeled independently (like optuna's default multivariate=False).

    The owning Study feeds it completed trials via ``observe``.

    Multi-objective studies (the reference's two-objective h36m conv study,
    conv_optuna_main.py:328-331) are handled honestly: every objective is
    observed, direction-adjusted, and the good/bad split is made on the
    scale-free rank-sum across objectives (a one-time warning notes this —
    the reference's own TPE study is single-objective).
    """

    def __init__(self, seed: int = 0, n_startup: int = 10, gamma: float = 0.25,
                 n_candidates: int = 24):
        import numpy as np

        self._rng = np.random.RandomState(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        # (params, direction-adjusted objective vector); lower is better
        self._history: list[tuple[dict, list]] = []
        self._warned_multiobjective = False

    def observe(self, params: dict, values, directions=("minimize",)) -> None:
        vals = list(values) if isinstance(values, (tuple, list)) else [values]
        dirs = list(directions) + ["minimize"] * (len(vals) - len(directions))
        signed = [float(v) if d == "minimize" else -float(v)
                  for v, d in zip(vals, dirs)]
        if len(signed) > 1 and not self._warned_multiobjective:
            self._warned_multiobjective = True
            import warnings

            warnings.warn(
                "TPESampler on a multi-objective study: the good/bad split "
                "uses the rank-sum over ALL objectives (scale-free "
                "scalarization), not a Pareto-aware MOTPE.",
                stacklevel=2,
            )
        self._history.append((dict(params), signed))

    @staticmethod
    def _scalar_keys(done: list) -> list:
        """Direction-adjusted values -> sortable scalars (rank-sum if multi)."""
        import numpy as np

        vals = np.asarray([v for _, v in done], dtype=np.float64)
        if vals.shape[1] == 1:
            return list(vals[:, 0])
        ranks = np.argsort(np.argsort(vals, axis=0), axis=0)
        return list(ranks.sum(axis=1).astype(np.float64))

    def _kde_logpdf(self, xs, obs, lo, hi):
        import numpy as np

        obs = np.asarray(obs, dtype=np.float64)
        bw = max((hi - lo) * 1.06 * len(obs) ** -0.2 / 4.0, 1e-12)
        d = (xs[:, None] - obs[None, :]) / bw
        return np.log(np.exp(-0.5 * d * d).sum(axis=1) + 1e-12)

    def sample(self, trial_number: int, name: str, choices: list) -> Any:
        import numpy as np

        done = [(p, v) for p, v in self._history if name in p]
        if len(done) < self.n_startup:
            return choices[int(self._rng.randint(len(choices)))]

        numeric = all(isinstance(c, (int, float)) and not isinstance(c, bool)
                      for c in choices)
        keys = self._scalar_keys(done)
        done = [done[i] for i in np.argsort(keys, kind="stable")]
        n_good = max(1, int(np.ceil(self.gamma * len(done))))
        good = [p[name] for p, _ in done[:n_good]]
        bad = [p[name] for p, _ in done[n_good:]] or good

        if not numeric:
            # categorical: smoothed counts
            counts_g = {c: 1.0 for c in choices}
            counts_b = {c: 1.0 for c in choices}
            for v in good:
                counts_g[v] = counts_g.get(v, 1.0) + 1.0
            for v in bad:
                counts_b[v] = counts_b.get(v, 1.0) + 1.0
            scores = {c: counts_g[c] / counts_b[c] for c in choices}
            return max(choices, key=lambda c: scores[c])

        lo, hi = float(min(choices)), float(max(choices))
        cand_idx = self._rng.randint(len(choices), size=self.n_candidates)
        cands = np.asarray([choices[i] for i in cand_idx], dtype=np.float64)
        score = self._kde_logpdf(cands, good, lo, hi) - self._kde_logpdf(cands, bad, lo, hi)
        return choices[int(cand_idx[int(np.argmax(score))])]
