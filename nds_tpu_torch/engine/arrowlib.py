"""pyarrow for the engine's hot modules (engine/exec.py, engine/expr.py),
bound at first use.

The card's path runs without pyarrow (a table built from numpy never
loads it), so the hot modules may not import it at module level; and a
function-local `import` there would pay the import machinery on every
call. They import this module instead and read `arrowlib.pa` /
`arrowlib.pc`: the first read imports pyarrow and binds it here, every
later read is a module attribute lookup.
"""

from __future__ import annotations


def __getattr__(name):
    if name == "pa":
        import pyarrow as mod
    elif name == "pc":
        import pyarrow.compute as mod
    else:
        raise AttributeError(name)
    globals()[name] = mod
    return mod
