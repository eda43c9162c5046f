"""Export native sweep storage to optuna's RDB sqlite schema.

Counterpart of ``motionmixerconv_tpu/sweep/optuna_export.py``, unchanged
(``sqlite3`` only; it runs on the card's machine).

The reference's studies persist through optuna's sqlite storage and are
browsable with optuna-dashboard (conv_optuna_main.py:395-398). The native
engine (sweep/engine.py) uses its own 2-table schema; this module converts a
native study — live ``Study`` object or stored sqlite file — into a database
laid out exactly like optuna 3.x's RDB schema (schema_version 12), so
``optuna-dashboard sqlite:///out.db`` and ``optuna.load_study`` work on the
result without optuna being installed *here*.

Schema notes (mirrors optuna/storages/_rdb/models.py at schema_version 12):
- one row per study in ``studies``; per-objective rows in
  ``study_directions`` ('MINIMIZE'/'MAXIMIZE');
- ``trials`` holds number/state/datetimes; values live in ``trial_values``
  (objective index, value, value_type FINITE/INF_POS/INF_NEG);
- ``trial_params`` stores ``param_value`` as optuna's *internal* float
  representation: the raw value for Float/Int distributions, the index into
  ``choices`` for CategoricalDistribution; the distribution itself is JSON in
  ``distribution_json``;
- ``alembic_version``/``version_info`` pin the schema revision. A reader
  running a different optuna release may be told to run
  ``optuna storage upgrade --storage sqlite:///out.db`` — that is the
  supported optuna path and is non-destructive.

Distribution inference: the native engine samples from explicit choice lists
(grid spaces are persisted; otherwise observed values are used). Integer
lists that form an arithmetic progression export as IntDistribution, float
lists as a bounding FloatDistribution, everything else (strings, bools,
mixed, ragged ints) as CategoricalDistribution — which optuna renders
faithfully for grid studies anyway.

CLI: ``python -m motionmixerconv_tpu_torch.sweep.optuna_export native.db out.db``.
"""

from __future__ import annotations

import json
import math
import sqlite3
from datetime import datetime, timezone
from typing import Any, Optional, Sequence

SCHEMA_VERSION = 12
ALEMBIC_VERSION = "v3.2.0.a"  # optuna >= 3.2 head revision
LIBRARY_VERSION = "3.2.0"

_DDL = [
    """CREATE TABLE IF NOT EXISTS alembic_version (
        version_num VARCHAR(32) NOT NULL,
        CONSTRAINT alembic_version_pkc PRIMARY KEY (version_num))""",
    """CREATE TABLE IF NOT EXISTS version_info (
        version_info_id INTEGER NOT NULL,
        schema_version INTEGER,
        library_version VARCHAR(256),
        PRIMARY KEY (version_info_id),
        CHECK (version_info_id=1))""",
    """CREATE TABLE IF NOT EXISTS studies (
        study_id INTEGER NOT NULL,
        study_name VARCHAR(512) NOT NULL,
        PRIMARY KEY (study_id),
        UNIQUE (study_name))""",
    """CREATE TABLE IF NOT EXISTS study_directions (
        study_direction_id INTEGER NOT NULL,
        direction VARCHAR(8) NOT NULL,
        study_id INTEGER NOT NULL,
        objective INTEGER NOT NULL,
        PRIMARY KEY (study_direction_id),
        UNIQUE (study_id, objective),
        FOREIGN KEY(study_id) REFERENCES studies (study_id),
        CHECK (direction IN ('NOT_SET', 'MINIMIZE', 'MAXIMIZE')))""",
    """CREATE TABLE IF NOT EXISTS study_user_attributes (
        study_user_attribute_id INTEGER NOT NULL,
        study_id INTEGER,
        key VARCHAR(512),
        value_json VARCHAR(2048),
        PRIMARY KEY (study_user_attribute_id),
        UNIQUE (study_id, key),
        FOREIGN KEY(study_id) REFERENCES studies (study_id))""",
    """CREATE TABLE IF NOT EXISTS study_system_attributes (
        study_system_attribute_id INTEGER NOT NULL,
        study_id INTEGER,
        key VARCHAR(512),
        value_json VARCHAR(2048),
        PRIMARY KEY (study_system_attribute_id),
        UNIQUE (study_id, key),
        FOREIGN KEY(study_id) REFERENCES studies (study_id))""",
    """CREATE TABLE IF NOT EXISTS trials (
        trial_id INTEGER NOT NULL,
        number INTEGER,
        study_id INTEGER,
        state VARCHAR(8) NOT NULL,
        datetime_start DATETIME,
        datetime_complete DATETIME,
        PRIMARY KEY (trial_id),
        FOREIGN KEY(study_id) REFERENCES studies (study_id),
        CHECK (state IN ('RUNNING', 'COMPLETE', 'PRUNED', 'FAIL', 'WAITING')))""",
    """CREATE INDEX IF NOT EXISTS ix_trials_study_id ON trials (study_id)""",
    """CREATE TABLE IF NOT EXISTS trial_user_attributes (
        trial_user_attribute_id INTEGER NOT NULL,
        trial_id INTEGER,
        key VARCHAR(512),
        value_json VARCHAR(2048),
        PRIMARY KEY (trial_user_attribute_id),
        UNIQUE (trial_id, key),
        FOREIGN KEY(trial_id) REFERENCES trials (trial_id))""",
    """CREATE TABLE IF NOT EXISTS trial_system_attributes (
        trial_system_attribute_id INTEGER NOT NULL,
        trial_id INTEGER,
        key VARCHAR(512),
        value_json VARCHAR(2048),
        PRIMARY KEY (trial_system_attribute_id),
        UNIQUE (trial_id, key),
        FOREIGN KEY(trial_id) REFERENCES trials (trial_id))""",
    """CREATE TABLE IF NOT EXISTS trial_params (
        param_id INTEGER NOT NULL,
        trial_id INTEGER,
        param_name VARCHAR(512),
        param_value FLOAT,
        distribution_json TEXT,
        PRIMARY KEY (param_id),
        UNIQUE (trial_id, param_name),
        FOREIGN KEY(trial_id) REFERENCES trials (trial_id))""",
    """CREATE TABLE IF NOT EXISTS trial_values (
        trial_value_id INTEGER NOT NULL,
        trial_id INTEGER,
        objective INTEGER NOT NULL,
        value FLOAT,
        value_type VARCHAR(7) NOT NULL,
        PRIMARY KEY (trial_value_id),
        UNIQUE (trial_id, objective),
        FOREIGN KEY(trial_id) REFERENCES trials (trial_id),
        CHECK (value_type IN ('FINITE', 'INF_POS', 'INF_NEG')))""",
    """CREATE TABLE IF NOT EXISTS trial_intermediate_values (
        trial_intermediate_value_id INTEGER NOT NULL,
        trial_id INTEGER,
        step INTEGER NOT NULL,
        intermediate_value FLOAT,
        intermediate_value_type VARCHAR(7) NOT NULL,
        PRIMARY KEY (trial_intermediate_value_id),
        UNIQUE (trial_id, step),
        FOREIGN KEY(trial_id) REFERENCES trials (trial_id),
        CHECK (intermediate_value_type IN
               ('FINITE', 'INF_POS', 'INF_NEG', 'NAN')))""",
    """CREATE TABLE IF NOT EXISTS trial_heartbeats (
        trial_heartbeat_id INTEGER NOT NULL,
        trial_id INTEGER,
        heartbeat DATETIME NOT NULL,
        PRIMARY KEY (trial_heartbeat_id),
        UNIQUE (trial_id),
        FOREIGN KEY(trial_id) REFERENCES trials (trial_id))""",
]


def _is_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def infer_distribution(choices: Sequence[Any]) -> dict:
    """Map a native choice list to an optuna distribution dict.

    Returns {"name": ..., "attributes": {...}} ready for
    ``distribution_json``; see the module docstring for the inference rule.
    """
    vals = list(choices)
    if vals and all(_is_int(v) for v in vals):
        uniq = sorted(set(vals))
        if len(uniq) == 1:
            return {"name": "IntDistribution",
                    "attributes": {"log": False, "step": 1,
                                   "low": uniq[0], "high": uniq[0]}}
        steps = {b - a for a, b in zip(uniq, uniq[1:])}
        if len(steps) == 1:
            return {"name": "IntDistribution",
                    "attributes": {"log": False, "step": steps.pop(),
                                   "low": uniq[0], "high": uniq[-1]}}
    if vals and all(_is_num(v) for v in vals) and any(
            isinstance(v, float) for v in vals):
        lo, hi = float(min(vals)), float(max(vals))
        if math.isfinite(lo) and math.isfinite(hi):
            return {"name": "FloatDistribution",
                    "attributes": {"step": None, "low": lo,
                                   "high": max(hi, lo), "log": False}}
    return {"name": "CategoricalDistribution", "attributes": {"choices": vals}}


def _param_internal(value: Any, dist: dict) -> float:
    """optuna's internal float repr: value for Float/Int, index for Categorical."""
    if dist["name"] == "CategoricalDistribution":
        return float(dist["attributes"]["choices"].index(value))
    return float(value)


def _dt(t: Optional[float]) -> Optional[str]:
    if t is None:
        return None
    return datetime.fromtimestamp(t, tz=timezone.utc).strftime(
        "%Y-%m-%d %H:%M:%S.%f")


def _read_native(path: str) -> dict:
    """Native sqlite (engine.py tables) -> {study: {trials, spaces}}."""
    conn = sqlite3.connect(path)
    out: dict[str, dict] = {}
    try:
        rows = conn.execute(
            "SELECT study, number, state, values_json, params_json, "
            "user_attrs_json, t FROM trials ORDER BY study, number"
        ).fetchall()
        inter: dict[tuple, dict] = {}
        try:
            for study, num, step, value in conn.execute(
                    "SELECT study, number, step, value FROM intermediates"):
                inter.setdefault((study, num), {})[step] = value
        except sqlite3.OperationalError:
            pass  # db predates the intermediates table
        for study, num, st, vals, params, attrs, t in rows:
            d = out.setdefault(study, {"trials": [], "spaces": {}})
            d["trials"].append({
                "number": num, "state": st,
                "values": json.loads(vals) if vals else None,
                "params": json.loads(params), "user_attrs": json.loads(attrs),
                "t": t,
                "intermediate_values": inter.get((study, num), {}),
            })
        for study, name, cj in conn.execute(
                "SELECT study, name, choices_json FROM spaces ORDER BY ord"):
            out.setdefault(study, {"trials": [], "spaces": {}})
            out[study]["spaces"][name] = json.loads(cj)
        try:
            for study, key, vj in conn.execute(
                    "SELECT study, key, value_json FROM study_attrs"):
                out.setdefault(study, {"trials": [], "spaces": {}})
                out[study].setdefault("user_attrs", {})[key] = json.loads(vj)
        except sqlite3.OperationalError:
            pass  # db predates the study_attrs table
    finally:
        conn.close()
    return out


def _study_payload(study) -> dict:
    """Live engine.Study -> the same payload shape as _read_native."""
    spaces = {}
    sampler = getattr(study, "sampler", None)
    if sampler is not None and hasattr(sampler, "_spaces"):
        spaces = {k: list(v) for k, v in sampler._spaces.items()}
    return {
        "trials": [
            {"number": t.number, "state": t.state, "values": t.values,
             "params": t.params, "user_attrs": t.user_attrs, "t": None,
             "intermediate_values": getattr(t, "intermediate_values", {})}
            for t in study.trials
        ],
        "spaces": spaces,
        "user_attrs": dict(getattr(study, "user_attrs", {})),
    }


def export_optuna_sqlite(
    src,
    dst_path: str,
    *,
    directions: Optional[dict[str, Sequence[str]]] = None,
    alembic_version: str = ALEMBIC_VERSION,
    schema_version: int = SCHEMA_VERSION,
    library_version: str = LIBRARY_VERSION,
) -> list[str]:
    """Write ``src`` (engine.Study, or native sqlite path) as an
    optuna-schema sqlite db at ``dst_path``. Returns the exported study names.

    ``directions`` maps study name -> per-objective directions; a live Study
    carries its own, stored files default every objective to 'minimize'
    (the reference studies all minimize, conv_optuna_main.py:328-331).
    """
    from .engine import Study

    if isinstance(src, Study):
        studies = {src.study_name: _study_payload(src)}
        directions = directions or {src.study_name: src.directions}
    else:
        studies = _read_native(src)
    directions = directions or {}

    conn = sqlite3.connect(dst_path)
    try:
        for ddl in _DDL:
            conn.execute(ddl)
        conn.execute("DELETE FROM alembic_version")
        conn.execute("INSERT INTO alembic_version VALUES (?)",
                     (alembic_version,))
        conn.execute("INSERT OR REPLACE INTO version_info VALUES (1, ?, ?)",
                     (schema_version, library_version))

        for name, payload in studies.items():
            cur = conn.execute("INSERT INTO studies (study_name) VALUES (?)",
                               (name,))
            sid = cur.lastrowid
            n_obj = max([len(t["values"] or [1]) for t in payload["trials"]]
                        or [1])
            dirs = list(directions.get(name, [])) or ["minimize"] * n_obj
            dirs += ["minimize"] * (n_obj - len(dirs))
            for i, d in enumerate(dirs[:n_obj]):
                conn.execute(
                    "INSERT INTO study_directions (direction, study_id, "
                    "objective) VALUES (?, ?, ?)",
                    (d.upper(), sid, i))
            for key, v in payload.get("user_attrs", {}).items():
                conn.execute(
                    "INSERT INTO study_user_attributes (study_id, key, "
                    "value_json) VALUES (?, ?, ?)",
                    (sid, key, json.dumps(v)))

            # distributions: persisted grid spaces, else observed values
            observed: dict[str, list] = {}
            for t in payload["trials"]:
                for k, v in t["params"].items():
                    if v not in observed.setdefault(k, []):
                        observed[k].append(v)
            dists = {
                k: infer_distribution(payload["spaces"].get(k, vs))
                for k, vs in observed.items()
            }
            # widen categorical choices over ALL trials up front so every
            # inserted trial_params row carries the same final distribution
            # (optuna readers assume one distribution per param per study;
            # widening mid-insert would leave earlier rows with a stale,
            # narrower choice list)
            for t in payload["trials"]:
                for k, v in t["params"].items():
                    dist = dists[k]
                    if (dist["name"] == "CategoricalDistribution"
                            and v not in dist["attributes"]["choices"]):
                        dist["attributes"]["choices"].append(v)

            for t in payload["trials"]:
                cur = conn.execute(
                    "INSERT INTO trials (number, study_id, state, "
                    "datetime_start, datetime_complete) VALUES (?,?,?,?,?)",
                    (t["number"], sid, t["state"], _dt(t["t"]), _dt(t["t"])))
                tid = cur.lastrowid
                for i, v in enumerate(t["values"] or []):
                    v = float(v)
                    if math.isinf(v):
                        vt = "INF_POS" if v > 0 else "INF_NEG"
                        v = 0.0
                    else:
                        vt = "FINITE"
                    conn.execute(
                        "INSERT INTO trial_values (trial_id, objective, "
                        "value, value_type) VALUES (?,?,?,?)",
                        (tid, i, v, vt))
                for k, v in t["params"].items():
                    dist = dists[k]
                    conn.execute(
                        "INSERT INTO trial_params (trial_id, param_name, "
                        "param_value, distribution_json) VALUES (?,?,?,?)",
                        (tid, k, _param_internal(v, dist), json.dumps(dist)))
                for k, v in t["user_attrs"].items():
                    conn.execute(
                        "INSERT INTO trial_user_attributes (trial_id, key, "
                        "value_json) VALUES (?,?,?)",
                        (tid, k, json.dumps(v)))
                for step, v in sorted(
                        t.get("intermediate_values", {}).items()):
                    v = float(v)
                    if math.isnan(v):
                        vt, v = "NAN", 0.0
                    elif math.isinf(v):
                        vt = "INF_POS" if v > 0 else "INF_NEG"
                        v = 0.0
                    else:
                        vt = "FINITE"
                    conn.execute(
                        "INSERT INTO trial_intermediate_values (trial_id, "
                        "step, intermediate_value, intermediate_value_type) "
                        "VALUES (?,?,?,?)",
                        (tid, int(step), v, vt))
        conn.commit()
    finally:
        conn.close()
    return list(studies)


def main(argv: Optional[list[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert native sweep sqlite storage to optuna's RDB "
                    "schema (optuna-dashboard compatible).")
    ap.add_argument("src", help="native sqlite file written by sweep.engine")
    ap.add_argument("dst", help="output sqlite file (optuna schema)")
    ap.add_argument("--maximize", action="append", default=[], metavar="STUDY:OBJ",
                    help="mark objective OBJ (0-based) of STUDY as maximize; "
                         "repeatable (default: all objectives minimize)")
    args = ap.parse_args(argv)

    directions: dict[str, dict[int, str]] = {}
    for spec in args.maximize:
        study, _, obj = spec.rpartition(":")
        directions.setdefault(study, {})[int(obj)] = "maximize"
    dmap = {
        s: [v.get(i, "minimize") for i in range(max(v) + 1)]
        for s, v in directions.items()
    }
    names = export_optuna_sqlite(args.src, args.dst, directions=dmap)
    print(f"exported {len(names)} study(ies) to {args.dst}: {', '.join(names)}")


if __name__ == "__main__":
    main()
