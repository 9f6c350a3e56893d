"""The invariant contracts the repo's fast paths depend on, as data.

Every closed form this reproduction has landed (closed-form drain,
batched GTICK, batched waterfill) is *licensed* by contracts that used
to live only in docstrings and runtime pins:

  * policies draw randomness exclusively from the injected
    ``PolicyContext.rng`` stream (never global numpy/stdlib RNG state);
  * a ``drain_safe=True`` policy mutates observable state only inside
    ``route``/``propose`` (what lets the engine exit the heap once every
    arrival is routed);
  * sim-path code never consults wall clocks or environment ordering —
    one violation silently corrupts the rtol-1e-9 legacy equivalence
    pin;
  * the tick code performs no host syncs or Python branches on device
    values (what keeps the batched GTICK one dispatch).

This module states those contracts as plain data.  It is the port's copy
of ``src/repro/core/contracts.py``, value for value, so the port's runtime
(``from repro_torch.core import contracts``) names the same contract
without importing the reference package.  The static analyzer
(``tools/lint``) loads the reference's file by path and sweeps both
packages with it; the paths and pins below are the reference's.  Keep it
stdlib-only and side-effect-free.

``tests/test_torch_link.py`` holds :data:`CAPABILITY_FLAGS` against the
port's live ``RedistributionPolicy`` class attributes and against the
reference's copy, so the three cannot drift apart silently.
"""

from __future__ import annotations

# --------------------------------------------------------------------- #
# Capability-flag contract (repro.core.policy.RedistributionPolicy)
# --------------------------------------------------------------------- #

#: Every capability flag a registered policy may declare, with its
#: default value on the ``RedistributionPolicy`` base class.  The
#: capability lint pass starts each ``@register_policy`` class from
#: these defaults and applies the class-body overrides it can see.
CAPABILITY_FLAGS = {
    "uses_link": False,
    "never_redistributes": False,
    "drain_safe": True,
    "batched_waterfill": False,
    "pays_decision_overhead": True,
    "stochastic": False,
}

#: The decorator that marks a class as a registered policy (and thus
#: subject to the capability-contract pass).
POLICY_DECORATOR = "register_policy"

#: Methods in which a ``drain_safe=True`` policy may mutate ``self``:
#: construction, plus the two engine entry points that only run while
#: arrivals are still being routed.  Private helpers (``_name``) called
#: exclusively from these methods inherit the permission.  Anything
#: else — ``place_one``, ``wants_spread``, ``paces_spread``, mask
#: pushes — can fire after routing is complete, where a mutation would
#: invalidate the closed-form drain.
MUTATION_SAFE_METHODS = ("__init__", "route", "propose")

#: The injected-randomness attribute: any read of ``ctx.rng`` /
#: ``self.ctx.rng`` requires ``stochastic=True``.
RNG_ATTRIBUTE = "rng"

#: The adaptive-link mask attribute: reads (or a ``set_link_mask``
#: override) require ``uses_link=True`` — the engine only creates and
#: ticks link instances for policies that declare the flag.
LINK_MASK_ATTRIBUTE = "link_mask"


# --------------------------------------------------------------------- #
# Determinism contract (the sim/serving/data bit-identity surface)
# --------------------------------------------------------------------- #

#: Repo-relative directory prefixes in which global-state RNG, wall
#: clocks and environment-order iteration are forbidden.  Virtual time
#: comes from the event heap; randomness comes from seeds threaded
#: through configs (``np.random.default_rng(seed)`` is fine, the module
#: singleton and argless generators are not).
DETERMINISM_SCOPE = (
    "src/repro/sim/",
    "src/repro/core/",
    "src/repro/serving/",
    "src/repro/data/",
    # The fault-injection detection path: `sim/faults.py` is already
    # covered by the sim/ prefix; the runtime-side detector it drives
    # (heartbeats, N-strikes straggler exclusion, elastic remesh) must
    # hold the same bar — same-seed fault runs are pinned bit-for-bit.
    "src/repro/runtime/fault_tolerance.py",
)

#: Modules covered by bit-identity pins (the rtol-1e-9 legacy
#: equivalence pin of ``tests/test_sim_equivalence.py``, the policy
#: digest pins of ``tests/test_policy_interface.py``, and the pipeline
#: pins of ``tests/test_pipeline.py``).  The float-order pass flags
#: order-sensitive reductions over unordered containers here: a sum
#: whose operand order depends on set hashing is a different float
#: result on a different run.
PINNED_MODULES = (
    "src/repro/sim/engine.py",
    "src/repro/sim/faults.py",
    "src/repro/sim/legacy.py",
    "src/repro/sim/batched_link.py",
    "src/repro/sim/pipeline.py",
    "src/repro/core/state_machine.py",
    "src/repro/core/skew_models.py",
    "src/repro/core/admission.py",
    "src/repro/core/policy.py",
    "src/repro/core/adaptive_link.py",
    # Acknowledged by the dyflow pin-impact pass (DY602): these are
    # reachable from the pin roots through the interprocedural graph —
    # types.py batch helpers and the fault-tolerance detector feed every
    # pin; replay/workload feed the policy digest pins.
    "src/repro/core/types.py",
    "src/repro/runtime/fault_tolerance.py",
    "src/repro/sim/replay.py",
    "src/repro/sim/workload.py",
)


# --------------------------------------------------------------------- #
# Jit-reachability contract (the tick hot path)
# --------------------------------------------------------------------- #

#: Functions that are jit-reachable through CROSS-module dispatch the
#: per-module AST analysis cannot see (e.g. ``sim/engine.py`` jits
#: ``partial(_tick_impl, cfg=cfg)`` which calls
#: ``state_machine.tick``).  Maps repo-relative path -> {function name
#: -> tuple of parameter names that are static at every jit call site
#: (hashable config objects bound via ``partial`` or
#: ``static_argnames``)}.  The jax-hazard pass seeds its reachability
#: closure from these in addition to what it derives per module.
JIT_REACHABLE = {
    "src/repro/core/state_machine.py": {
        "tick": ("config",),
        "tick_many": ("config",),
        "advance": ("config",),
    },
    "src/repro/core/skew_models.py": {
        "detect_skew": ("config",),
        "update_metrics": (),
        "apply_n_strikes": ("n_strikes",),
        "heavy_row_disable": ("config",),
        "batch_density_heavy_rows": ("config",),
    },
    # train/loop.py jits the closure returned by make_train_step.
    "src/repro/train/step.py": {
        "train_step": (),
    },
}


#: Calls whose results are static (trace-time Python values) even
#: though the per-module analysis cannot prove it: host-side config
#: reads that are constant for the lifetime of a trace.
STATIC_CALLS = (
    "repro.models.perf_flags.get_flags",
)


# --------------------------------------------------------------------- #
# Units/dimension contract (the DY5xx dyflow pass)
# --------------------------------------------------------------------- #

#: The unit vocabulary: name suffix -> (dimension, scale).  A name
#: carrying one of these suffixes (``wall_s``, ``kv_bytes``,
#: ``deficit_rows``) declares the unit of the value it binds; the
#: units pass seeds its dataflow from these, propagates through
#: assignments, arithmetic, calls and returns, and flags cross-DIMENSION
#: mixing (seconds added to bytes) and same-dimension SCALE mixing
#: (``*_gb`` compared to ``*_bytes``) repo-wide.  Scales are relative to
#: the dimension's canonical unit (seconds / bytes / rows / tokens).
UNIT_SUFFIXES = {
    "s": ("seconds", 1.0),
    "secs": ("seconds", 1.0),
    "seconds": ("seconds", 1.0),
    "ms": ("seconds", 1e-3),
    "us": ("seconds", 1e-6),
    "ns": ("seconds", 1e-9),
    "bytes": ("bytes", 1.0),
    "kb": ("bytes", 2.0 ** 10),
    "mb": ("bytes", 2.0 ** 20),
    "gb": ("bytes", 2.0 ** 30),
    "rows": ("rows", 1.0),
    "tokens": ("tokens", 1.0),
}

#: Whole-name override patterns, checked BEFORE the suffix rules
#: (regex, (dimension, scale)).  ``worker_seconds_spent`` is the
#: autoscale economics currency (worker-count x wall seconds — NOT
#: addable to plain latency seconds); ``cost_per_slo`` and ``frac_*`` /
#: ``*_frac`` names are dimensionless ratios despite any embedded unit
#: token (``frac_tokens`` is a fraction OF tokens, not a token count).
UNIT_NAME_PATTERNS = (
    (r"(^|_)worker_seconds(_|$)", ("worker_seconds", 1.0)),
    (r"(^|_)cost_per_slo(_|$)", ("ratio", 1.0)),
    (r"(^|_)frac(tion)?(_|$)", ("ratio", 1.0)),
    (r"(^|_)(jain|ratio|attainment)(_|$)", ("ratio", 1.0)),
)

#: Near-miss suffixes that look like units but are OUTSIDE the
#: vocabulary.  ``tools/check_bench.py`` rejects BENCH row keys carrying
#: one (a ``p99_sec`` column is a mislabeled ``p99_s``), and the units
#: pass treats them as unit-intent it cannot resolve.
UNIT_SUFFIX_NEAR_MISSES = {
    "sec": "s", "msec": "ms", "msecs": "ms", "millis": "ms",
    "usec": "us", "usecs": "us", "nanos": "ns", "byte": "bytes",
    "kib": "kb", "mib": "mb", "gib": "gb", "token": "tokens",
}

#: Repo-relative prefixes the units pass sweeps (the whole production
#: tree plus the benches that mint BENCH records from its numbers).
UNITS_SCOPE = ("src/repro/", "benchmarks/")


# --------------------------------------------------------------------- #
# Pin-impact contract (the DY6xx dyflow pass)
# --------------------------------------------------------------------- #

#: Repo-relative prefix the whole-program call graph covers.
GRAPH_SCOPE = ("src/repro/",)

#: Registry-mediated dispatch: calling one of the FACTORIES yields "some
#: registered policy", so a method call on the result is an edge to that
#: method on the base class and on EVERY ``@register_policy`` subclass.
#: Declared here (not inferred) because the registry's dict lives behind
#: runtime decoration the static graph cannot execute.
POLICY_REGISTRY = {
    "module": "src/repro/core/policy.py",
    "base": "RedistributionPolicy",
    "decorator": POLICY_DECORATOR,
    "factories": ("resolve_policy", "make_policy", "policy_class"),
}

#: The bit-identity pins, as data: pin name -> (test anchor, call-graph
#: roots).  The DY6xx pass computes the reachability closure of each
#: root set over the interprocedural call graph, commits it as
#: ``tools/lint/pin_map.json`` (stale map = lint failure), and checks
#: that every closure module is acknowledged in :data:`PINNED_MODULES` —
#: so "which functions feed which pins" is an artifact CI can diff a PR
#: against, not tribal knowledge.
PINS = {
    "legacy_equivalence_rtol1e9": {
        "test": "tests/test_sim_equivalence.py",
        "roots": (
            "src/repro/sim/engine.py::Simulator.run_query",
            "src/repro/sim/engine.py::MultiQuerySimulator.run",
            "src/repro/sim/legacy.py::LegacySimulator.run_query",
        ),
    },
    "policy_digests": {
        "test": "tests/test_policy_interface.py",
        "roots": (
            "src/repro/sim/engine.py::MultiQuerySimulator.run",
            "src/repro/sim/replay.py::run_open_loop",
        ),
    },
    "pipeline_digests": {
        "test": "tests/test_pipeline.py",
        "roots": (
            "src/repro/sim/pipeline.py::PipelineSimulator.run",
        ),
    },
    "fault_bit_identity": {
        "test": "tests/test_faults.py",
        "roots": (
            "src/repro/sim/engine.py::MultiQuerySimulator.run",
            "src/repro/sim/faults.py::hazard_schedule",
        ),
    },
}

#: Where the committed pin-impact map lives (regenerate with
#: ``python tools/lint/runner.py --write-pin-map``).
PIN_MAP_PATH = "tools/lint/pin_map.json"


# --------------------------------------------------------------------- #
# Lint surface
# --------------------------------------------------------------------- #

#: Default root-relative paths ``make lint`` sweeps.  Tests are
#: deliberately excluded: lint fixtures (including a deliberately
#: misdeclared policy) live under ``tests/lint_fixtures/``.
DEFAULT_LINT_PATHS = ("src", "tools", "benchmarks")
