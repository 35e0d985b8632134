"""Generate the markdown API reference (docs/api/*.md) from the package's
docstrings -- the counterpart of the reference's Sphinx autodoc pages
(``/root/reference/doc/api.rst``).

    python docs/gen_api.py          # rewrites docs/api/*.md
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODULES = [
    ("density", [
        "pypmc_tpu.density.core",
        "pypmc_tpu.density.base",
        "pypmc_tpu.density.gauss",
        "pypmc_tpu.density.student_t",
        "pypmc_tpu.density.mixture",
        "pypmc_tpu.density._partition",
    ]),
    ("sampler", [
        "pypmc_tpu.sampler.importance_sampling",
        "pypmc_tpu.sampler.markov_chain",
        "pypmc_tpu.sampler._target",
    ]),
    ("mix_adapt", [
        "pypmc_tpu.mix_adapt.pmc",
        "pypmc_tpu.mix_adapt.variational",
        "pypmc_tpu.mix_adapt.hierarchical",
        "pypmc_tpu.mix_adapt.r_value",
    ]),
    ("parallel", [
        "pypmc_tpu.parallel.mesh",
        "pypmc_tpu.parallel.sampler",
    ]),
    ("pipeline", [
        "pypmc_tpu.pipeline",
    ]),
    ("ops", [
        "pypmc_tpu.ops.linalg",
        "pypmc_tpu.ops.lse",
        "pypmc_tpu.ops.random",
        "pypmc_tpu.ops.mixture_kernel",
    ]),
    ("tools", [
        "pypmc_tpu.tools._history",
        "pypmc_tpu.tools.indicator",
        "pypmc_tpu.tools.convergence",
        "pypmc_tpu.tools._plot",
        "pypmc_tpu.tools.util",
        "pypmc_tpu.tools._probability_densities",
        "pypmc_tpu.checkpoint",
        "pypmc_tpu.profiling",
    ]),
]


def _unwrap(obj):
    """Strip jit/functools wrappers so signatures come from the user code."""
    for attr in ("__wrapped__", "func"):
        inner = getattr(obj, attr, None)
        if inner is not None and callable(inner):
            return _unwrap(inner)
    return obj


def _signature(name, obj):
    try:
        sig = str(inspect.signature(_unwrap(obj)))
    except (ValueError, TypeError):
        sig = "(...)"
    return "%s%s" % (name, sig)


def _doc(obj):
    doc = inspect.getdoc(obj)
    return doc.strip() if doc else "*(no docstring)*"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None:
            continue
        target = _unwrap(obj)
        home = getattr(target, "__module__", mod.__name__)
        if inspect.ismodule(obj) or home.split(".")[0] != "pypmc_tpu":
            continue
        out.append((n, obj))
    return out


def render_module(qualname):
    mod = importlib.import_module(qualname)
    lines = ["## `%s`" % qualname, "", _doc(mod), ""]
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += ["### class `%s`" % _signature(name, obj.__init__ if
                                                    obj.__init__ is not object.__init__ else obj),
                      "", _doc(obj), ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not callable(meth):
                    continue
                if not any(mname in vars(k) for k in obj.__mro__
                           if k.__module__.startswith("pypmc_tpu")):
                    continue
                lines += ["#### `%s.%s`" % (name, _signature(mname, meth)),
                          "", _doc(meth), ""]
            for pname, prop in inspect.getmembers(
                    obj, lambda o: isinstance(o, property)):
                if pname.startswith("_"):
                    continue
                lines += ["#### property `%s.%s`" % (name, pname), "",
                          _doc(prop), ""]
        elif callable(obj):
            lines += ["### `%s`" % _signature(name, obj), "", _doc(obj), ""]
        else:
            lines += ["### data `%s`" % name, "", "`%r`" % (obj,), ""]
    return "\n".join(lines)


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="generate into a temp dir and diff against "
                         "docs/api (exit 1 when stale) -- the CI doc job "
                         "and tests/test_docs.py use this")
    args = ap.parse_args()

    docs_api = os.path.join(os.path.dirname(os.path.abspath(__file__)), "api")
    cleanup_dir = None
    if args.check:
        import filecmp
        import tempfile

        out_dir = cleanup_dir = tempfile.mkdtemp(prefix="gen_api_check_")
    else:
        out_dir = docs_api
    os.makedirs(out_dir, exist_ok=True)
    index = ["# API reference",
             "",
             "Generated from the package docstrings by `docs/gen_api.py`"
             " (counterpart of the reference's Sphinx autodoc,"
             " `/root/reference/doc/api.rst`).  Docstrings cite the"
             " reference implementation as `path:line` for parity checks.",
             ""]
    for page, modules in MODULES:
        fname = "%s.md" % page
        body = ["# `pypmc_tpu.%s`" % page if page != "tools"
                else "# `pypmc_tpu.tools` + top-level utilities", ""]
        for qualname in modules:
            body.append(render_module(qualname))
            body.append("")
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write("\n".join(body))
        index.append("- [%s](%s)" % (page, fname))
        print("wrote docs/api/%s" % fname)
    index.append("- [references](../references.md) \u2014 collected "
                 "bibliography for the [Cap+08]-style citation keys")
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print("wrote docs/api/README.md")

    if args.check:
        import shutil

        try:
            stale = []
            for fn in sorted(os.listdir(out_dir)):
                current = os.path.join(docs_api, fn)
                if not os.path.exists(current) or not filecmp.cmp(
                        os.path.join(out_dir, fn), current, shallow=False):
                    stale.append(fn)
            extra = sorted(
                set(os.listdir(docs_api)) - set(os.listdir(out_dir)))
        finally:
            shutil.rmtree(cleanup_dir, ignore_errors=True)
        if stale or extra:
            print("STALE docs/api (rerun python docs/gen_api.py): %s"
                  % ", ".join(stale + ["extra:" + e for e in extra]))
            raise SystemExit(1)
        print("docs/api is current")


if __name__ == "__main__":
    main()
