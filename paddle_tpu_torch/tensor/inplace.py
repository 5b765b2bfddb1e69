"""The in-place ``op_`` forms (counterpart of
``paddle_tpu/tensor/inplace.py``, with its own copy of JAX's table).

Each is generated from its functional base: the op runs out of place and
the handle is rebound to the result (``Tensor._inplace_assign``), as in
JAX.  An op that read the tensor earlier keeps the old value and its
gradient; a leaf that requires grad and is changed under ``no_grad``
keeps requiring it (its storage takes the new values).
"""

from __future__ import annotations

from .tensor import Tensor

__all__ = []


def _make(name: str, base):
    def op_(x, *args, **kwargs):
        if not isinstance(x, Tensor):
            raise TypeError(f"{name} requires a Tensor, got {type(x)}")
        return x._inplace_assign(base(x, *args, **kwargs))
    op_.__name__ = op_.__qualname__ = name
    op_.__doc__ = f"In-place variant of :func:`{base.__name__}`."
    globals()[name] = op_
    __all__.append(name)
    return op_


# (in-place name, source module, functional base name)
_TABLE = [
    ("addmm_", "math", "addmm"), ("cumsum_", "math", "cumsum"),
    ("cumprod_", "math", "cumprod"), ("logit_", "math", "logit"),
    ("tan_", "math", "tan"), ("acos_", "math", "acos"),
    ("atan_", "math", "atan"), ("sinh_", "math", "sinh"),
    ("expm1_", "math", "expm1"), ("square_", "math", "square"),
    ("erf_", "math", "erf"), ("log_", "math", "log"),
    ("log2_", "math", "log2"), ("log10_", "math", "log10"),
    ("trunc_", "math", "trunc"), ("frac_", "math", "frac"),
    ("digamma_", "math", "digamma"), ("lgamma_", "math", "lgamma"),
    ("gammaln_", "math", "gammaln"), ("gcd_", "math", "gcd"),
    ("lcm_", "math", "lcm"), ("hypot_", "math", "hypot"),
    ("ldexp_", "math", "ldexp"), ("i0_", "math", "i0"),
    ("copysign_", "math", "copysign"), ("nan_to_num_", "math", "nan_to_num"),
    ("floor_divide_", "math", "floor_divide"), ("floor_mod_", "math", "mod"),
    ("logical_and_", "logic", "logical_and"),
    ("logical_or_", "logic", "logical_or"),
    ("logical_xor_", "logic", "logical_xor"),
    ("logical_not_", "logic", "logical_not"),
    ("bitwise_and_", "math", "bitwise_and"),
    ("bitwise_or_", "math", "bitwise_or"),
    ("bitwise_xor_", "math", "bitwise_xor"),
    ("bitwise_not_", "math", "bitwise_not"),
    ("equal_", "logic", "equal"), ("less_than_", "logic", "less_than"),
    ("less_equal_", "logic", "less_equal"),
    ("greater_than_", "logic", "greater_than"),
    ("greater_equal_", "logic", "greater_equal"),
    ("tril_", "creation", "tril"), ("triu_", "creation", "triu"),
    ("t_", "manipulation", "t"), ("transpose_", "manipulation", "transpose"),
    ("index_add_", "manipulation", "index_add"),
    ("index_put_", "manipulation", "index_put"),
    ("index_fill_", "extras", "index_fill"),
    ("masked_fill_", "manipulation", "masked_fill"),
    ("masked_scatter_", "manipulation", "masked_scatter"),
    ("renorm_", "extras", "renorm"), ("sinc_", "extras", "sinc"),
    ("gammainc_", "extras", "gammainc"), ("gammaincc_", "extras", "gammaincc"),
    ("multigammaln_", "extras", "multigammaln"),
    ("polygamma_", "extras", "polygamma"),
    ("bitwise_left_shift_", "extras", "bitwise_left_shift"),
    ("bitwise_right_shift_", "extras", "bitwise_right_shift"),
]


def _init():
    import importlib
    for name, mod, base_name in _TABLE:
        base = getattr(importlib.import_module(f"{__package__}.{mod}"),
                       base_name)
        _make(name, base)


_init()
