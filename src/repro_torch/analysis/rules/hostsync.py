"""ZL004: host synchronization inside serving hot paths (PyTorch).

A decode step on the card is asynchronous end to end: the runner
enqueues kernels and the only host<->device round trip is the one
batched token fetch per step.  Any *extra* sync in the per-token path --
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
``int()``/``float()``/``bool()`` of a tensor, ``np.asarray`` of one, an
implicit bool test -- stalls the CUDA stream once per token per request,
and is exactly what a CUDA-graph capture of the step cannot contain.

Hot paths are the reference's (``decode``/``prefill`` on ``*Runner``
classes, the per-tick methods of ``*Engine`` classes), closed over the
methods they call through ``self.`` (:func:`~repro_torch.analysis.rules.
common.hot_functions`).  Device values are tracked per function:

* the results of the model's calls (a callee reached through a
  ``model`` attribute: ``self.model.prefill(...)``);
* the results of ``torch.*`` ops on device values, of a ``torch.*``
  factory given a ``device=`` other than the CPU, and of ``.to(<a
  device>)``/``.cuda()``: a factory without ``device=`` makes a host
  tensor, whose ``.tolist()`` syncs nothing;
* the runner's device state (``params``, ``cache``, ``layers``,
  ``k_pages``, ``v_pages`` attributes) and parameters annotated
  ``torch.Tensor``;
* anything computed from a device value: a method of it, an index of
  it, a call taking it, or a call of a function of this module whose
  return is a device value (a summary iterated to a fixpoint).

Metadata (``.shape``, ``.dtype``, ``.device``, ``.numel()``, ``.size()``,
``.dim()``) and identity tests (``is``, ``is not``) are host values.  The
rule flags every host-forcing operation on a device value, plus the two
that sync whatever their operand: ``.item()`` and
``torch.cuda.synchronize()``.  The deliberate one-sync-per-step sites
carry a ``# zenlint-torch: ignore[ZL004]`` with their justification;
together they are the inventory a captured decode step must remove.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set, Tuple

from repro_torch.analysis.engine import (Module, Rule, dotted,
                                         own_statements, stmt_exprs)
from repro_torch.analysis.rules.common import assigned_names, hot_functions

COERCIONS = {"int", "float", "bool", "complex"}
#: methods that copy a tensor to the host (each one blocks on the stream)
HOST_METHODS = {"tolist", "item", "cpu", "numpy"}
#: attribute reads and methods that return host metadata, never data
META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
              "requires_grad"}
META_METHODS = {"size", "dim", "numel", "nelement", "stride",
                "element_size", "is_contiguous", "data_ptr", "get_device"}
#: the runner's device state
DEVICE_ATTRS = {"params", "cache", "layers", "k_pages", "v_pages"}
#: torch factories: a host tensor unless ``device=`` names another device
FACTORIES = {"tensor", "as_tensor", "from_numpy", "zeros", "ones", "empty",
             "full", "arange", "linspace", "rand", "randn", "randint",
             "randperm", "eye"}
#: builtins whose result is a host value whatever they are given
HOST_BUILTINS = {"len", "isinstance", "range", "enumerate", "zip", "print",
                 "repr", "str", "id", "type", "hasattr", "getattr"}
NP_FETCH = ("np.asarray", "np.array", "numpy.asarray", "numpy.array")


def _leaf(path: Optional[str]) -> Optional[str]:
    return None if path is None else path.rsplit(".", 1)[-1]


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and dotted(node.func) == "torch.device"
            and bool(node.args) and _is_cpu(node.args[0]))


def _names_device(node: ast.AST) -> bool:
    """Whether a ``.to()``/``device=`` argument names a device (not a
    dtype): ``"cuda"``, ``torch.device(...)``, or a name spelled like
    one (``dev``, ``self.device``)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value != "cpu"
    if isinstance(node, ast.Call):
        return dotted(node.func) == "torch.device" and not _is_cpu(node)
    leaf = _leaf(dotted(node))
    return leaf is not None and "dev" in leaf


class _Device:
    """Device-value evaluation over one module (summaries) and one
    function (the names bound so far)."""

    def __init__(self, summaries: Dict[str, bool]):
        self.summaries = summaries

    def dev(self, node: ast.AST, env: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in env
        if isinstance(node, ast.Attribute):
            d = dotted(node)
            if d is not None and d in env:
                return True
            if node.attr in META_ATTRS:
                return False
            return node.attr in DEVICE_ATTRS or self.dev(node.value, env)
        if isinstance(node, ast.Subscript):
            return self.dev(node.value, env)
        if isinstance(node, ast.Call):
            return self._call(node, env)
        if isinstance(node, ast.BinOp):
            return self.dev(node.left, env) or self.dev(node.right, env)
        if isinstance(node, ast.UnaryOp):
            return self.dev(node.operand, env)
        if isinstance(node, ast.BoolOp):
            return any(self.dev(v, env) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self.dev(v, env)
                       for v in [node.left] + node.comparators)
        if isinstance(node, ast.IfExp):
            return self.dev(node.body, env) or self.dev(node.orelse, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.dev(e, env) for e in node.elts)
        if isinstance(node, ast.Starred):
            return self.dev(node.value, env)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp)):
            return self.dev(node.elt, env)
        return False

    def _args(self, call: ast.Call, env: Set[str]) -> bool:
        return any(self.dev(a, env) for a in call.args) or any(
            self.dev(kw.value, env) for kw in call.keywords)

    def _call(self, call: ast.Call, env: Set[str]) -> bool:
        d = dotted(call.func)
        leaf = _leaf(d)
        if isinstance(call.func, ast.Name):
            name = call.func.id
            if name in COERCIONS or name in HOST_BUILTINS:
                return False
            if name in self.summaries:
                return self.summaries[name]
            return self._args(call, env)
        if d in NP_FETCH:
            return False
        if d is not None and d.split(".", 1)[0] == "torch":
            if leaf in FACTORIES:
                return any(kw.arg == "device" and _names_device(kw.value)
                           for kw in call.keywords)
            return self._args(call, env)
        if not isinstance(call.func, ast.Attribute):
            return self._args(call, env)
        recv = call.func.value
        method = call.func.attr
        if method in HOST_METHODS or method in META_METHODS:
            return False
        if method == "to":
            targets = list(call.args) + [kw.value for kw in call.keywords
                                         if kw.arg == "device"]
            if any(_is_cpu(t) for t in targets):
                return False
            return self.dev(recv, env) or any(_names_device(t)
                                              for t in targets)
        if method == "cuda":
            return True
        rd = dotted(recv)
        if rd is not None and "model" in rd.split("."):
            return True                 # the model's calls
        on_self = ((isinstance(recv, ast.Name) and recv.id == "self")
                   or (isinstance(recv, ast.Call)
                       and dotted(recv.func) == "super"))
        if on_self and method in self.summaries:
            return self.summaries[method]
        return self.dev(recv, env) or self._args(call, env)


def _annotated_tensors(fn: ast.AST) -> Set[str]:
    """Parameters of ``fn`` and of the functions nested in it that are
    annotated ``torch.Tensor`` (or ``Tensor``)."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        a = n.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.annotation is not None and _leaf(
                    dotted(p.annotation)) == "Tensor":
                out.add(p.arg)
    return out


def _bind(stmt: ast.stmt, env: Set[str], dv: _Device) -> None:
    """Update ``env`` with the names ``stmt`` binds."""
    if isinstance(stmt, ast.Assign):
        pairs = []
        for t in stmt.targets:
            if (isinstance(t, (ast.Tuple, ast.List))
                    and isinstance(stmt.value, (ast.Tuple, ast.List))
                    and len(t.elts) == len(stmt.value.elts)):
                pairs.extend(zip(t.elts, stmt.value.elts))
            else:
                pairs.append((t, stmt.value))
        for tgt, val in pairs:
            is_dev = dv.dev(val, env)
            for path in assigned_names(tgt):
                if is_dev:
                    env.add(path)
                else:
                    env.discard(path)
    elif isinstance(stmt, ast.AugAssign):
        d = dotted(stmt.target)
        if d is not None and dv.dev(stmt.value, env):
            env.add(d)


def _summaries(mod: Module) -> Dict[str, bool]:
    """Name -> whether a function of that name in this module returns a
    device value (any of its own valued returns; OR over same-named
    defs), iterated to a fixpoint."""
    funcs = list(mod.functions())
    out: Dict[str, bool] = {f.name: False for f in funcs}
    for _ in range(4):
        dv = _Device(out)
        new: Dict[str, bool] = {f.name: False for f in funcs}
        for f in funcs:
            env = _annotated_tensors(f.node)
            for stmt in own_statements(f.node):
                if isinstance(stmt, ast.Return) and stmt.value is not None:
                    if dv.dev(stmt.value, env):
                        new[f.name] = True
                _bind(stmt, env, dv)
        if new == out:
            break
        out = new
    return out


class HostSyncInHotPath(Rule):
    rule_id = "ZL004"
    title = "host synchronization in serving hot paths"

    def run(self, mod: Module) -> Iterator[Tuple[int, str]]:
        hot = hot_functions(mod)
        if not hot:
            return
        dv = _Device(_summaries(mod))
        for func in hot:
            env = _annotated_tensors(func.node)
            for stmt in func.statements():
                for expr in stmt_exprs(stmt):
                    yield from self._check_expr(expr, env, dv)
                if (isinstance(stmt, (ast.If, ast.While))
                        and dv.dev(stmt.test, env)):
                    yield (stmt.lineno,
                           "implicit bool() of a device value in a test: "
                           "this blocks on the stream -- restructure, or "
                           "fetch once explicitly")
                # bind AFTER checking: a host-forcing call's result is a
                # host value, so downstream reads of it are sync-free
                _bind(stmt, env, dv)

    def _check_expr(self, expr: ast.AST, env: Set[str],
                    dv: _Device) -> Iterator[Tuple[int, str]]:
        for call in (n for n in ast.walk(expr) if isinstance(n, ast.Call)):
            cd = dotted(call.func)
            method = (call.func.attr if isinstance(call.func, ast.Attribute)
                      else None)
            if method == "item":
                yield (call.lineno,
                       ".item() in a hot path: one blocking device->host "
                       "transfer per call -- batch the fetch per step")
            elif cd == "torch.cuda.synchronize":
                yield (call.lineno,
                       "torch.cuda.synchronize() in a hot path: the host "
                       "waits for the whole stream")
            elif (method in ("tolist", "cpu", "numpy")
                  and dv.dev(call.func.value, env)):
                yield (call.lineno,
                       f".{method}() of a device value in a hot path: "
                       "blocking device->host transfer -- keep the value "
                       "on the card or batch the fetch per step")
            elif (method == "to" and dv.dev(call.func.value, env)
                  and any(_is_cpu(a) for a in list(call.args) + [
                      kw.value for kw in call.keywords
                      if kw.arg == "device"])):
                yield (call.lineno,
                       ".to('cpu') of a device value in a hot path: "
                       "blocking device->host transfer")
            elif (cd in NP_FETCH and call.args
                  and dv.dev(call.args[0], env)):
                yield (call.lineno,
                       f"{cd} of a device value in a hot path: blocking "
                       "device->host transfer -- keep the value on the "
                       "card or batch the fetch")
            elif (isinstance(call.func, ast.Name)
                  and call.func.id in COERCIONS and call.args
                  and dv.dev(call.args[0], env)):
                yield (call.lineno,
                       f"{call.func.id}() of a device value in a hot "
                       "path: implicit blocking sync -- fetch the batch "
                       "once (.tolist() after the step) and index that")
