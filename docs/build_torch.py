#!/usr/bin/env python3
"""API reference generator for the PyTorch + CUDA port, ``tomobar_tpu_torch``.

Walks the package and renders every public module, class and function
docstring into ``docs/torch/api/*.md`` plus an index, in the manner of
``docs/build.py`` (which renders the JAX package)::

    python docs/build_torch.py        # writes docs/torch/api/

It imports the port only (never jax): importing the package builds no
kernel and needs no CUDA.  The CUDA sources (``csrc``), the build loader
(``_build``) and the native preprocessing library's loader (``native``)
are not rendered.  A module that does not import stops the build.
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
API_DIR = os.path.join(ROOT, "docs", "torch", "api")
PACKAGE = "tomobar_tpu_torch"
SKIP = ("csrc", "_build", "native")
UNDOCUMENTED = "*Undocumented.*"


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    return inspect.getdoc(obj) or UNDOCUMENTED


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def render_module(modname: str) -> str:
    """The Markdown page of module ``modname``: its docstring, then each
    public class (with its public methods) and function defined in the
    package, in ``__all__`` where the module has one."""
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`", "", _doc(mod), ""]
    exported = getattr(mod, "__all__", None)

    def want(name, obj):
        if not _is_public(name) or (exported is not None and name not in exported):
            return False
        return getattr(obj, "__module__", modname).startswith(PACKAGE)

    members = vars(mod)
    classes = [(n, o) for n, o in members.items() if inspect.isclass(o) and want(n, o)]
    funcs = [(n, o) for n, o in members.items() if inspect.isfunction(o) and want(n, o)]
    for name, cls in classes:
        lines += [f"## class `{name}{_sig(cls)}`", "", _doc(cls), ""]
        for mname, meth in inspect.getmembers(cls):
            if (_is_public(mname) and inspect.isfunction(meth)
                    and meth.__qualname__.startswith(cls.__name__)):
                lines += [f"### `{name}.{mname}{_sig(meth)}`", "", _doc(meth), ""]
    for name, fn in funcs:
        lines += [f"## `{name}{_sig(fn)}`", "", _doc(fn), ""]
    return "\n".join(lines)


def module_names() -> list:
    """Every module of the package that gets a page, sorted."""
    pkg = importlib.import_module(PACKAGE)
    names = [PACKAGE]
    for info in pkgutil.walk_packages(pkg.__path__, prefix=PACKAGE + "."):
        if not set(info.name.split(".")[1:]) & set(SKIP):
            names.append(info.name)
    return sorted(names)


def page_name(modname: str) -> str:
    return modname.replace(".", "_") + ".md"


def build(out_dir: str) -> list:
    """Render every page and the index into ``out_dir``; returns the file names."""
    os.makedirs(out_dir, exist_ok=True)
    index = ["# API reference of `tomobar_tpu_torch`", "",
             "Generated by `python docs/build_torch.py`.", ""]
    written = []
    for modname in module_names():
        fname = page_name(modname)
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(render_module(modname) + "\n")
        index.append(f"- [`{modname}`]({fname})")
        written.append(fname)
    with open(os.path.join(out_dir, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    return written + ["index.md"]


def main() -> None:
    for fname in build(API_DIR):
        print(f"wrote {os.path.relpath(os.path.join(API_DIR, fname), ROOT)}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
