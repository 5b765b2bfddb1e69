"""Dynamic-to-static control-flow conversion.

Counterpart of ``paddle_tpu/jit/dy2static.py``: the same AST pass
(:func:`ast_transform` rewrites every ``if`` / ``while`` into
:func:`convert_ifelse` / :func:`convert_while_loop` calls, and leaves
unsupported shapes, an early ``return`` or ``break``, a non-name target,
as plain Python), with the two dispatchers written on torch.

A predicate is "traced" when it is a Tensor and host reads are forbidden
(``tensor.forbid_host_reads``: ``jit.to_static``'s checked run of a
signature, a CUDA graph capture, an export), where JAX's would be a
tracer.  Otherwise both dispatchers keep plain Python semantics.

* ``convert_ifelse`` on a traced predicate runs both branches and selects
  each Tensor of their results with ``where`` (JAX's ``lax.cond`` runs
  one; the values and the gradients, the taken branch's, are the same).
  Both branches must give the same structure, and equal non-Tensor
  values.
* ``convert_while_loop`` on a traced predicate raises :class:`DeviceLoop`:
  a loop whose trip count lives on the device cannot be one CUDA graph
  without conditional nodes, so ``jit.to_static`` runs that signature
  eagerly (JAX compiles a ``lax.while_loop``; ROADMAP.md queue 3).
"""

from __future__ import annotations

import ast
import inspect
import textwrap
from typing import Callable, Optional

import torch

from ..ops.dispatch import apply, as_tensor
from ..tensor.tensor import Tensor, host_reads_forbidden

__all__ = ["convert_ifelse", "convert_while_loop", "ast_transform",
           "UNDEF", "capture", "DeviceLoop"]


class DeviceLoop(RuntimeError):
    """A converted ``while`` whose predicate is a traced Tensor: the trip
    count lives on the device, so the signature runs eagerly."""


class _Undefined:
    """Sentinel for names not yet bound when a branch captures scope."""

    def __repr__(self):
        return "<undefined>"


UNDEF = _Undefined()


def capture(local_vars: dict, names):
    """Snapshot ``names`` out of ``locals()`` (UNDEF when absent)."""
    return {n: local_vars.get(n, UNDEF) for n in names}


def _is_traced(x) -> bool:
    return isinstance(x, Tensor) and host_reads_forbidden() is not None


def _flatten(out):
    """A tree of tuples / lists / dicts -> (leaves, rebuild(iterator))."""
    if isinstance(out, (tuple, list)):
        parts = [_flatten(o) for o in out]

        def rebuild(it, _parts=parts, _type=type(out)):
            return _type(p[1](it) for p in _parts)
        return [leaf for p in parts for leaf in p[0]], rebuild
    if isinstance(out, dict):
        keys = list(out)
        parts = [_flatten(out[k]) for k in keys]

        def rebuild_d(it, _parts=parts, _keys=keys):
            return {k: p[1](it) for k, p in zip(_keys, _parts)}
        return [leaf for p in parts for leaf in p[0]], rebuild_d
    return [out], lambda it: next(it)


def _select(pred, a, b):
    """``a`` where ``pred`` else ``b``, for one pair of branch leaves."""
    if not isinstance(a, Tensor) and not isinstance(b, Tensor):
        if a is b or (type(a) is type(b) and a == b):
            return a
        raise TypeError(
            f"convert_ifelse: the branches give different non-Tensor "
            f"values ({a!r} vs {b!r}) under a traced predicate")
    a, b = as_tensor(a), as_tensor(b)
    if a.shape != b.shape:
        raise TypeError(
            f"convert_ifelse: the branches give shapes {a.shape} and "
            f"{b.shape} under a traced predicate")
    return apply("cond", lambda p, x, y: torch.where(
        p.reshape(()).to(torch.bool), x, y), pred, a, b)


def convert_ifelse(pred, true_fn: Callable, false_fn: Callable):
    """Runtime dispatch for a rewritten ``if``:

    * a concrete predicate -> the plain Python branch (autograd records
      only the taken branch);
    * a traced predicate -> both branches, each Tensor selected by the
      predicate on the device.
    """
    if not _is_traced(pred):
        return true_fn() if bool(pred) else false_fn()
    if pred.size != 1:
        raise ValueError("The truth value of a Tensor with more than one "
                         "element is ambiguous.")
    t_leaves, rebuild = _flatten(true_fn())
    f_leaves, f_rebuild = _flatten(false_fn())
    if len(t_leaves) != len(f_leaves):
        raise TypeError("convert_ifelse: branches produce different "
                        "structures")
    return rebuild(iter([_select(pred, a, b)
                         for a, b in zip(t_leaves, f_leaves)]))


def convert_while_loop(cond_fn: Callable, body_fn: Callable, carry):
    """Runtime dispatch for a rewritten ``while``: a plain Python loop
    while each predicate is concrete; :class:`DeviceLoop` at a traced
    one."""
    vals = tuple(carry)
    while True:
        c = cond_fn(*vals)
        if _is_traced(c):
            raise DeviceLoop(
                "a while loop on a device predicate: its trip count is on "
                "the device, so this signature runs eagerly")
        if not bool(c):
            return vals
        vals = tuple(body_fn(*vals))


# ---------------------------------------------------------------------------
# AST pass
# ---------------------------------------------------------------------------
class _Unsupported(Exception):
    pass


def _assigned_names(nodes) -> Optional[set]:
    """Names bound by simple assignments in a statement list (recursing
    into nested if/while); None when an unsupported construct appears."""
    names: set = set()
    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.Return, ast.Break, ast.Continue,
                                ast.Raise, ast.Try, ast.With,
                                ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef, ast.Global, ast.Nonlocal,
                                ast.Import, ast.ImportFrom,
                                ast.Delete)):
                return None
            if isinstance(sub, ast.NamedExpr):
                names.add(sub.target.id)
            if isinstance(sub, ast.For):
                if isinstance(sub.target, ast.Name):
                    names.add(sub.target.id)
                elif isinstance(sub.target, (ast.Tuple, ast.List)) and \
                        all(isinstance(e, ast.Name)
                            for e in sub.target.elts):
                    names.update(e.id for e in sub.target.elts)
                else:
                    return None
            if isinstance(sub, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                targets = sub.targets if isinstance(sub, ast.Assign) \
                    else [sub.target]
                for t in targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        for el in t.elts:
                            if isinstance(el, ast.Name):
                                names.add(el.id)
                            else:
                                return None
                    elif isinstance(t, (ast.Subscript, ast.Attribute)):
                        return None
                    else:
                        return None
    return names


def _names_in(node) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


class _CFTransformer(ast.NodeTransformer):
    """Rewrite ``if``/``while`` statements into convert_* calls.

    ``local_names``: names local to the function being transformed —
    predicate names are intersected with it so builtins/globals
    appearing in a test (``len``, module names) are NOT captured into
    branch parameters (capturing them would shadow them with UNDEF)."""

    def __init__(self, local_names=frozenset()):
        self._n = 0
        self._locals = set(local_names)

    def _uid(self) -> int:
        self._n += 1
        return self._n

    def visit_If(self, node: ast.If):
        self.generic_visit(node)
        assigned_t = _assigned_names(node.body)
        assigned_f = _assigned_names(node.orelse)
        if assigned_t is None or assigned_f is None:
            return node         # unsupported shape: leave as Python
        assigned = sorted(set(assigned_t) | set(assigned_f))
        if not assigned:
            return node         # side-effect-only branches: leave
        uid = self._uid()
        live = sorted(set(assigned) |
                      (_names_in(node.test) & self._locals))
        cap_name = f"__dy2st_live_{uid}"
        args = [ast.arg(arg=n) for n in live]
        defaults = [ast.Subscript(
            value=ast.Name(id=cap_name, ctx=ast.Load()),
            slice=ast.Constant(value=n), ctx=ast.Load()) for n in live]
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in assigned],
            ctx=ast.Load()))

        def branch(name, body):
            return ast.FunctionDef(
                name=name,
                args=ast.arguments(posonlyargs=[], args=args,
                                   vararg=None, kwonlyargs=[],
                                   kw_defaults=[], kwarg=None,
                                   defaults=defaults),
                body=(body or [ast.Pass()]) + [ret],
                decorator_list=[], type_params=[])

        cap = ast.Assign(
            targets=[ast.Name(id=cap_name, ctx=ast.Store())],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__dy2st__", ctx=ast.Load()),
                    attr="capture", ctx=ast.Load()),
                args=[ast.Call(func=ast.Name(id="locals",
                                             ctx=ast.Load()),
                               args=[], keywords=[]),
                      ast.Constant(value=live)],
                keywords=[]))
        t_name, f_name = f"__dy2st_true_{uid}", f"__dy2st_false_{uid}"
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store())
                      for n in assigned], ctx=ast.Store())],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__dy2st__", ctx=ast.Load()),
                    attr="convert_ifelse", ctx=ast.Load()),
                args=[node.test,
                      ast.Name(id=t_name, ctx=ast.Load()),
                      ast.Name(id=f_name, ctx=ast.Load())],
                keywords=[]))
        return [cap, branch(t_name, node.body),
                branch(f_name, node.orelse), call]

    def visit_While(self, node: ast.While):
        self.generic_visit(node)
        if node.orelse:
            return node
        assigned = _assigned_names(node.body)
        if assigned is None or not assigned:
            return node
        uid = self._uid()
        loop_vars = sorted(set(assigned) |
                           (_names_in(node.test) & self._locals))
        cap_name = f"__dy2st_live_{uid}"
        args = [ast.arg(arg=n) for n in loop_vars]
        ret = ast.Return(value=ast.Tuple(
            elts=[ast.Name(id=n, ctx=ast.Load()) for n in loop_vars],
            ctx=ast.Load()))
        c_name, b_name = f"__dy2st_cond_{uid}", f"__dy2st_body_{uid}"
        cond_def = ast.FunctionDef(
            name=c_name,
            args=ast.arguments(posonlyargs=[], args=args, vararg=None,
                               kwonlyargs=[], kw_defaults=[],
                               kwarg=None, defaults=[]),
            body=[ast.Return(value=node.test)], decorator_list=[],
            type_params=[])
        body_def = ast.FunctionDef(
            name=b_name,
            args=ast.arguments(posonlyargs=[], args=args, vararg=None,
                               kwonlyargs=[], kw_defaults=[],
                               kwarg=None, defaults=[]),
            body=list(node.body) + [ret], decorator_list=[],
            type_params=[])
        cap = ast.Assign(
            targets=[ast.Name(id=cap_name, ctx=ast.Store())],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__dy2st__", ctx=ast.Load()),
                    attr="capture", ctx=ast.Load()),
                args=[ast.Call(func=ast.Name(id="locals",
                                             ctx=ast.Load()),
                               args=[], keywords=[]),
                      ast.Constant(value=loop_vars)],
                keywords=[]))
        call = ast.Assign(
            targets=[ast.Tuple(
                elts=[ast.Name(id=n, ctx=ast.Store())
                      for n in loop_vars], ctx=ast.Store())],
            value=ast.Call(
                func=ast.Attribute(
                    value=ast.Name(id="__dy2st__", ctx=ast.Load()),
                    attr="convert_while_loop", ctx=ast.Load()),
                args=[ast.Name(id=c_name, ctx=ast.Load()),
                      ast.Name(id=b_name, ctx=ast.Load()),
                      ast.Tuple(elts=[
                          ast.Subscript(
                              value=ast.Name(id=cap_name,
                                             ctx=ast.Load()),
                              slice=ast.Constant(value=n),
                              ctx=ast.Load()) for n in loop_vars],
                          ctx=ast.Load())],
                keywords=[]))
        return [cap, cond_def, body_def, call]


class _Dy2StModule:
    """The ``__dy2st__`` name injected into transformed functions."""
    capture = staticmethod(capture)
    convert_ifelse = staticmethod(convert_ifelse)
    convert_while_loop = staticmethod(convert_while_loop)


def ast_transform(func: Callable) -> Optional[Callable]:
    """Rewrite ``func``'s if/while statements into convert_* calls.
    Returns the transformed function, or None when the source is
    unavailable / the rewrite fails (caller keeps the original)."""
    try:
        src = textwrap.dedent(inspect.getsource(func))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        fdef.decorator_list = []
        # function-local names: parameters + every name assigned
        # anywhere in the body (predicates are intersected with this so
        # builtins/globals never become captured branch parameters)
        local_names = {a.arg for a in (
            fdef.args.posonlyargs + fdef.args.args +
            fdef.args.kwonlyargs)}
        for va in (fdef.args.vararg, fdef.args.kwarg):
            if va is not None:
                local_names.add(va.arg)
        for sub in ast.walk(fdef):
            if isinstance(sub, ast.Name) and \
                    isinstance(sub.ctx, ast.Store):
                local_names.add(sub.id)
            elif isinstance(sub, ast.NamedExpr):
                local_names.add(sub.target.id)
        new = _CFTransformer(local_names).visit(fdef)
        ast.fix_missing_locations(tree)
        code_globals = dict(func.__globals__)
        code_globals["__dy2st__"] = _Dy2StModule
        freevars = func.__code__.co_freevars
        if freevars:
            outer = (f"def __dy2st_outer__({', '.join(freevars)}):\n"
                     + textwrap.indent(ast.unparse(tree), "    ")
                     + f"\n    return {fdef.name}")
            exec(compile(outer, f"<dy2static {func.__qualname__}>",
                         "exec"), code_globals)
            cells = [c.cell_contents for c in (func.__closure__ or ())]
            out = code_globals["__dy2st_outer__"](*cells)
        else:
            exec(compile(ast.unparse(tree),
                         f"<dy2static {func.__qualname__}>", "exec"),
                 code_globals)
            out = code_globals[fdef.name]
        out.__dy2static_transformed__ = True
        return out
    except Exception:
        return None
