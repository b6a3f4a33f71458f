"""Everything the JAX package does has its counterpart in the port, or a
stated reason why not.

The test walks every module of ``irbfn_tpu/`` and, in each, every public
top-level function and class (read from the source, so nothing is
imported from the JAX package), and every script of the repository
(``scripts/*.py`` and the root's ``*.py``) that imports ``jax`` or
``irbfn_tpu``. Each must either

- have a counterpart in ``irbfn_tpu_torch`` that imports and has the
  attribute: by default the same module path and name, else the one
  ``RENAMED`` or ``SCRIPTS`` names (a script's counterpart is a module
  with ``main``); or
- be listed in ``NOT_PORTED`` or ``SCRIPTS`` with one of ``REASONS``.

A name added on the JAX side alone fails the first test; an entry of the
tables that no longer names a JAX function, class or script fails the
second. Each flag of such a script's parser (read from its source) is a
flag of its port module's parser, under the same name or the one
``RENAMED_FLAGS`` states.
"""

import argparse
import ast
import importlib
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "irbfn_tpu")

XLA_TPU = "XLA/TPU-only (ROADMAP item 13)"
BENCH = "the earlier benchmark harness (bench.py)"
EXPORTER = "the checkpoint exporter, which needs JAX by design"
REASONS = (XLA_TPU, BENCH, EXPORTER)

# (JAX module, name) -> "port module:attribute" where the port's name or
# place differs
RENAMED = {
    ("irbfn_tpu.models.wcrbf", "RegionRBFCore"):
        "irbfn_tpu_torch.models.wcrbf:region_features",
    ("irbfn_tpu.ops.pallas_admm", "admm_solve_pallas"):
        "irbfn_tpu_torch.ops.admm:admm_solve",
    ("irbfn_tpu.ops.pallas_rbf", "wcrbf_forward_pallas"):
        "irbfn_tpu_torch.ops.rbf:wcrbf_forward",
    ("irbfn_tpu.ops.pallas_rbf", "wcrbf_params_to_pallas"):
        "irbfn_tpu_torch.ops.rbf:wcrbf_params_to_kernel",
    ("irbfn_tpu.solvers.goal_mpc", "solve_goal_family_pallas"):
        "irbfn_tpu_torch.solvers.goal_mpc:solve_goal_family",
    ("irbfn_tpu.train.trainer", "TrainState"):
        "irbfn_tpu_torch.train.trainer:Trainer",
    ("irbfn_tpu.train.trainer", "create_train_state"):
        "irbfn_tpu_torch.train.trainer:create_trainer",
    ("irbfn_tpu.utils.profiling", "MetricLogger"):
        "irbfn_tpu_torch.utils.metrics:MetricLogger",
}
# (JAX module, name) -> reason
NOT_PORTED = {
    ("irbfn_tpu.utils.cache", "enable_compilation_cache"): XLA_TPU,
    ("irbfn_tpu.utils.profiling", "chain_latency"): XLA_TPU,
    ("irbfn_tpu.utils.profiling", "RetraceGuard"): XLA_TPU,
}
# script (relative to the root) -> its port module (run with main) or a
# reason
SCRIPTS = {
    "__graft_entry__.py": "irbfn_tpu_torch.graft_entry",
    "bench.py": BENCH,
    "scripts/cluster_constraints.py":
        "irbfn_tpu_torch.train.cluster_constraints",
    "scripts/demo_closed_loop.py": "irbfn_tpu_torch.sim.demo_closed_loop",
    "scripts/demo_overtake.py": "irbfn_tpu_torch.sim.demo_overtake",
    "scripts/demo_traj_fan.py": "irbfn_tpu_torch.planning.demo_traj_fan",
    "scripts/eval_adaptive.py": "irbfn_tpu_torch.sim.eval_adaptive",
    "scripts/eval_closed_loop.py": "irbfn_tpu_torch.sim.eval_closed_loop",
    "scripts/eval_goal_mpc.py": "irbfn_tpu_torch.train.eval_goal_mpc",
    "scripts/eval_lut_accuracy.py": "irbfn_tpu_torch.train.eval_lut_accuracy",
    "scripts/eval_nmpc_oracle.py": "irbfn_tpu_torch.solvers.eval_nmpc_oracle",
    "scripts/eval_offline.py": "irbfn_tpu_torch.train.eval_offline",
    "scripts/export_torch_ckpt.py": EXPORTER,
    "scripts/gen_clothoid_lut.py": "irbfn_tpu_torch.parallel.gen_clothoid_lut",
    "scripts/gen_goal_mpc_table.py":
        "irbfn_tpu_torch.parallel.gen_goal_mpc_table",
    "scripts/gen_nmpc_table_cartesian.py":
        "irbfn_tpu_torch.parallel.gen_nmpc_table_cartesian",
    "scripts/gen_nmpc_table_frenet.py":
        "irbfn_tpu_torch.parallel.gen_nmpc_table_frenet",
    "scripts/gen_test_oracles.py": "irbfn_tpu_torch.solvers.gen_test_oracles",
    "scripts/make_feasible_raceline.py":
        "irbfn_tpu_torch.sim.make_feasible_raceline",
    "scripts/min_curv_raceline.py": "irbfn_tpu_torch.sim.min_curv_raceline",
    "scripts/patch_table_stragglers.py":
        "irbfn_tpu_torch.parallel.patch_table_stragglers",
    "scripts/plot_eval.py": "irbfn_tpu_torch.sim.plot_eval",
    # --parts nmpc (the ceilings and the roofline) and --parts trajgen
    "scripts/profile_nmpc.py": "irbfn_tpu_torch.utils.profiling",
    "scripts/profile_throughput.py": "irbfn_tpu_torch.utils.profiling",
    "scripts/quadrotor_pipeline.py":
        "irbfn_tpu_torch.train.quadrotor_pipeline",
    "scripts/train_cartesian.py": "irbfn_tpu_torch.train.train_cartesian",
    "scripts/train_clothoid.py": "irbfn_tpu_torch.train.train_clothoid",
    "scripts/train_frenet.py": "irbfn_tpu_torch.train.train_frenet",
    "scripts/train_goal_mpc.py": "irbfn_tpu_torch.train.train_goal_mpc",
    "scripts/train_ppo.py": "irbfn_tpu_torch.train.train_ppo",
}
# (script, its flag) -> the port module's flag where the name differs
RENAMED_FLAGS = {
    # the NMPC rows per solve; the port's --batch is profile_throughput.py's
    # TrajGen batch (both scripts are one module)
    ("scripts/profile_nmpc.py", "batch"): "nmpc_batches",
}
JAX_IMPORT = re.compile(r"^\s*(import jax\b|from jax\b|import irbfn_tpu\b"
                        r"|from irbfn_tpu(\.| import))", re.M)


def jax_names():
    """{(module, name)} of every public top-level def and class of the JAX
    package, from its sources."""
    out = set()
    for d, _, files in os.walk(JAX_PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
            mod = rel[:-len(".__init__")] if rel.endswith(".__init__") else rel
            with open(path) as fh:
                tree = ast.parse(fh.read())
            out |= {(mod, n.name) for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and not n.name.startswith("_")}
    return out


def jax_scripts():
    """The repository's scripts that import JAX or the JAX package."""
    paths = [f for f in os.listdir(ROOT) if f.endswith(".py")]
    paths += [os.path.join("scripts", f)
              for f in os.listdir(os.path.join(ROOT, "scripts"))
              if f.endswith(".py")]
    out = set()
    for p in paths:
        with open(os.path.join(ROOT, p)) as fh:
            if JAX_IMPORT.search(fh.read()):
                out.add(p.replace(os.sep, "/"))
    return out


def _has(target: str) -> bool:
    mod, _, attr = target.partition(":")
    return hasattr(importlib.import_module(mod), attr)


NAMES = sorted(jax_names())


def test_the_walk_finds_the_package():
    assert len(NAMES) > 200 and ("irbfn_tpu.solvers.nmpc",
                                 "solve_lattice_point") in NAMES
    assert {"bench.py", "scripts/profile_nmpc.py"} <= jax_scripts()
    assert "chip_smoke.py" not in jax_scripts()


@pytest.mark.parametrize("module", sorted({m for m, _ in NAMES}))
def test_every_jax_name_has_a_counterpart_or_a_reason(module):
    missing = []
    for mod, name in NAMES:
        if mod != module:
            continue
        if (mod, name) in NOT_PORTED:
            assert NOT_PORTED[mod, name] in REASONS
            continue
        target = RENAMED.get((mod, name),
                             f"irbfn_tpu_torch{mod[len('irbfn_tpu'):]}:{name}")
        if not _has(target):
            missing.append(f"{mod}.{name} -> {target}")
    assert not missing, missing


def test_the_tables_name_only_what_exists():
    stale = (set(RENAMED) | set(NOT_PORTED)) - set(NAMES)
    assert not stale, stale
    assert not set(RENAMED) & set(NOT_PORTED)
    assert set(SCRIPTS) == jax_scripts(), (
        set(SCRIPTS) ^ jax_scripts())


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_every_jax_script_has_a_module_or_a_reason(script):
    target = SCRIPTS[script]
    if target in REASONS:
        return
    if script == "__graft_entry__.py":  # the entry, not a command line
        assert _has(f"{target}:entry") and _has(f"{target}:dryrun_multichip")
        return
    assert _has(f"{target}:main"), target


def test_the_port_imports_nothing_of_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|from irbfn_tpu\.|"
                         r"import irbfn_tpu\b)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "irbfn_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    bad = []
    for f in files:
        with open(f) as fh:
            if pattern.search(fh.read()):
                bad.append(os.path.relpath(f, ROOT))
    assert not bad, bad


def script_flags(script: str) -> set:
    """The long flags a script's parser declares, read from its source:
    ``add_argument`` with a string, or with an f-string inside ``for``
    loops over literal sequences (or module-level names bound to one)."""
    with open(os.path.join(ROOT, script)) as fh:
        tree = ast.parse(fh.read())
    consts = {}
    for n in tree.body:
        if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name):
            try:
                consts[n.targets[0].id] = ast.literal_eval(n.value)
            except ValueError:
                pass
    flags = set()

    def bind(target, value, env):
        if isinstance(target, ast.Name):
            env[target.id] = value
        else:
            for t, v in zip(target.elts, value):
                bind(t, v, env)

    def text(node, env):
        if isinstance(node, ast.Constant):
            return node.value
        return "".join(str(env[v.value.id]) if isinstance(
            v, ast.FormattedValue) else v.value for v in node.values)

    def visit(node, env):
        if isinstance(node, ast.Call) and getattr(node.func, "attr",
                                                  None) == "add_argument":
            flag = text(node.args[0], env)
            if flag.startswith("--"):
                flags.add(flag[2:])
        seq = None
        if isinstance(node, ast.For):
            try:
                seq = (consts[node.iter.id] if isinstance(node.iter, ast.Name)
                       else ast.literal_eval(node.iter))
            except (KeyError, ValueError):  # not a literal sequence
                pass
        if seq is not None:
            for item in seq:
                bind(node.target, item, inner := dict(env))
                for stmt in node.body:
                    visit(stmt, inner)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, env)

    visit(tree, {})
    return flags


class _Parsed(Exception):
    pass


def port_flags(module: str) -> set:
    """The long flags of a port module's parser: ``main([])`` is stopped
    where it parses."""
    real = (argparse.ArgumentParser.parse_args,
            argparse.ArgumentParser.parse_known_args)
    got = []

    def capture(self, *args, **kwargs):
        got.append(self)
        raise _Parsed

    mod = importlib.import_module(module)
    argparse.ArgumentParser.parse_args = capture
    argparse.ArgumentParser.parse_known_args = capture
    try:
        mod.main([])
    except _Parsed:
        pass
    finally:
        (argparse.ArgumentParser.parse_args,
         argparse.ArgumentParser.parse_known_args) = real
    assert got, f"{module}.main([]) parsed nothing"
    return {o[2:] for o in got[0]._option_string_actions
            if o.startswith("--")}


def test_script_flags_reads_loops_over_literals():
    assert {"v_car_min", "v_car_max", "d_v_car", "chunk"} <= script_flags(
        "scripts/gen_goal_mpc_table.py")
    assert {"batch", "reps", "trace_dir", "json"} == script_flags(
        "scripts/profile_nmpc.py")


@pytest.mark.parametrize("script", sorted(
    s for s, t in SCRIPTS.items()
    if t not in REASONS and s != "__graft_entry__.py"))
def test_every_script_flag_is_a_port_flag(script):
    flags, ported = script_flags(script), port_flags(SCRIPTS[script])
    renamed = {f: t for (s, f), t in RENAMED_FLAGS.items() if s == script}
    assert set(renamed) <= flags, set(renamed) - flags
    missing = {f for f in flags if renamed.get(f, f) not in ported}
    assert not missing, sorted(missing)
