"""Implicitron's dependency-injection config system (port of
pytorch3d_tpu/implicitron/tools/config.py).

Configs are plain nested dicts (omegaconf is not installed) with the key
structure upstream uses: `x_args` for a Configurable member, `x_class_type`
and `x_<Impl>_args` for a ReplaceableBase member, `x_enabled` for an
Optional Configurable, and a class's `x_tweak_args(type, args)` hook.

    class MyBase(ReplaceableBase):
        pass

    @registry.register
    class MyImpl(MyBase):
        param: int = 3

    class Outer(Configurable):
        inner: MyBase
        inner_class_type: str = "MyImpl"
        x: float = 1.0

        def __post_init__(self):
            run_auto_creation(self)

    cfg = get_default_args(Outer)      # nested plain dict
    cfg["inner_MyImpl_args"]["param"] = 5
    outer = Outer(**cfg)               # outer.inner is a MyImpl(param=5)

A Configurable may also be a `torch.nn.Module` (`class Net(Configurable,
torch.nn.Module)`): its members and parameters register as submodules and
parameters, so `.to()`, `state_dict()` and `parameters()` see them.
"""

from __future__ import annotations

import dataclasses
import inspect
import typing
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch

ARGS_SUFFIX = "_args"
CLASS_TYPE_SUFFIX = "_class_type"
IMPL_SUFFIX = "_args"
ENABLED_SUFFIX = "_enabled"
TWEAK_SUFFIX = "_tweak_args"


class ReplaceableBase:
    """Base for plugin hierarchies whose members are chosen by a
    `<member>_class_type` string; implementations register with `registry`."""


class Configurable:
    """Base for config dataclasses whose members are built from their
    arguments (`expand_args_fields`, `run_auto_creation`)."""


class _Registry:
    """Global registry of ReplaceableBase implementations."""

    def __init__(self) -> None:
        self._mapping: Dict[type, Dict[str, type]] = defaultdict(dict)

    def register(self, some_class: type) -> type:
        """Class decorator registering an implementation."""
        name = some_class.__name__
        base = self._base_class(some_class)
        if base is None:
            raise ValueError(
                f"Cannot register {some_class}. Cannot tell what it is."
            )
        self._mapping[base][name] = some_class
        return some_class

    def _base_class(self, some_class: type) -> Optional[type]:
        for base in inspect.getmro(some_class)[1:]:
            if base is ReplaceableBase:
                return None  # direct subclass of ReplaceableBase w/o own base
            if (
                issubclass(base, ReplaceableBase)
                and ReplaceableBase in base.__bases__
            ):
                return base
        # fall back: nearest ancestor that directly derives ReplaceableBase
        for base in inspect.getmro(some_class):
            if ReplaceableBase in getattr(base, "__bases__", ()):
                return base
        return None

    def get(self, base_class_wanted: type, name: str) -> type:
        if base_class_wanted not in self._mapping or name not in self._mapping[
            base_class_wanted
        ]:
            raise ValueError(
                f"{name} has not been registered as a {base_class_wanted.__name__}."
            )
        return self._mapping[base_class_wanted][name]

    def get_all(self, base_class_wanted: type) -> List[type]:
        return list(self._mapping.get(base_class_wanted, {}).values())


registry = _Registry()


def _is_configurable_type(t) -> bool:
    return isinstance(t, type) and issubclass(t, (Configurable, ReplaceableBase))


def _resolve_optional(t):
    """Optional[X] -> (True, X); else (False, t)."""
    if typing.get_origin(t) is typing.Union:
        args = typing.get_args(t)
        non_none = [a for a in args if a is not type(None)]
        if len(non_none) == 1:
            return True, non_none[0]
    return False, t


def get_default_args(C) -> Dict[str, Any]:
    """Expanded default config of a Configurable / ReplaceableBase class or
    of a function: a plain nested dict."""
    if C is None:
        return {}
    if _is_configurable_type(C):
        expand_args_fields(C)
        out: Dict[str, Any] = {}
        for field in dataclasses.fields(C):
            if not field.init or field.name in ("parent", "name"):
                continue
            if field.default is not dataclasses.MISSING:
                out[field.name] = field.default
            elif field.default_factory is not dataclasses.MISSING:
                out[field.name] = field.default_factory()
        return out
    # plain function / class: signature defaults (enable_get_default_args)
    sig = inspect.signature(C)
    out = {}
    for name, p in sig.parameters.items():
        if p.default is not inspect.Parameter.empty:
            out[name] = p.default
    return out


def enable_get_default_args(C, *, overwrite: bool = True) -> None:
    """No-op: `get_default_args` reads a plain callable's signature as it is
    (upstream registers pickling helpers for omegaconf here)."""


def _fixup_class_init(some_class: type) -> None:
    """Make the generated dataclass `__init__` of a `torch.nn.Module`
    Configurable run `nn.Module.__init__` first, so that assigning a
    submodule or a parameter (in `__post_init__` or `run_auto_creation`)
    finds the module's registries."""
    dataclass_init = some_class.__init__

    def __init__(self, *args, **kwargs) -> None:
        torch.nn.Module.__init__(self)
        dataclass_init(self, *args, **kwargs)

    __init__.__qualname__ = f"{some_class.__qualname__}.__init__"
    some_class.__init__ = __init__


def expand_args_fields(some_class: type) -> type:
    """Transform a Configurable subclass into a dataclass (`eq=False`) with
    the expanded `x_args` / `x_class_type` / `x_<Impl>_args` / `x_enabled`
    fields.  Idempotent; mutates and returns the class.  A `torch.nn.Module`
    Configurable gets an `__init__` that runs `nn.Module.__init__` before it
    sets the fields (`_fixup_class_init`)."""
    if "_processed_members" in some_class.__dict__:
        return some_class

    hints = typing.get_type_hints(some_class)
    annotations = {}
    for klass in reversed(some_class.__mro__):
        # Only Configurable bases contribute fields: annotations of foreign
        # bases in a hybrid MRO (torch.nn.Module's `training: bool`) are not
        # fields.
        if klass is not some_class and not (
            isinstance(klass, type)
            and issubclass(klass, (Configurable, ReplaceableBase))
        ):
            continue
        annotations.update(getattr(klass, "__annotations__", {}))

    processed: Dict[str, Any] = {}
    new_annotations: Dict[str, Any] = {}
    new_defaults: Dict[str, Any] = {}

    for name, ann in annotations.items():
        if name.startswith("_"):
            continue
        ann = hints.get(name, ann)
        is_optional, inner = _resolve_optional(ann)

        if _is_configurable_type(inner) and issubclass(inner, ReplaceableBase):
            # pluggable member: class_type selector + per-impl args
            processed[name] = ("replaceable", inner, is_optional)
            tweak = getattr(some_class, name + TWEAK_SUFFIX, None)
            ct_name = name + CLASS_TYPE_SUFFIX
            if ct_name not in annotations:
                new_annotations[ct_name] = str
                new_defaults[ct_name] = getattr(
                    some_class, ct_name, "" if not is_optional else None
                )
            for impl in registry.get_all(inner):
                expand_args_fields(impl)
                args_name = f"{name}_{impl.__name__}{IMPL_SUFFIX}"
                new_annotations[args_name] = dict
                new_defaults[args_name] = _DefaultFactory(impl, tweak)
            # keep the member itself out of __init__
            new_annotations[name] = typing.Any
            new_defaults[name] = None
        elif _is_configurable_type(inner):
            processed[name] = ("configurable", inner, is_optional)
            tweak = getattr(some_class, name + TWEAK_SUFFIX, None)
            expand_args_fields(inner)
            args_name = name + ARGS_SUFFIX
            new_annotations[args_name] = dict
            new_defaults[args_name] = _DefaultFactory(inner, tweak)
            if is_optional:
                en_name = name + ENABLED_SUFFIX
                if en_name not in annotations:
                    new_annotations[en_name] = bool
                    new_defaults[en_name] = False
            new_annotations[name] = typing.Any
            new_defaults[name] = None
        else:
            new_annotations[name] = ann
            if name in some_class.__dict__:
                default = some_class.__dict__[name]
                if isinstance(default, dataclasses.Field):
                    # `x: T = field(...)` on a not-yet-dataclass body
                    if default.default is not dataclasses.MISSING:
                        new_defaults[name] = default.default
                    elif default.default_factory is not dataclasses.MISSING:
                        new_defaults[name] = _CallFactory(
                            default.default_factory
                        )
                    else:
                        new_defaults[name] = _MISSING_SENTINEL
                elif isinstance(default, (list, dict, set)):
                    new_defaults[name] = _ValueFactory(default)
                else:
                    new_defaults[name] = default
            elif (
                dataclasses.is_dataclass(some_class)
                and name in some_class.__dataclass_fields__
            ):
                # already-a-dataclass: factory defaults live only in
                # __dataclass_fields__ (dataclass strips the class attr)
                f = some_class.__dataclass_fields__[name]
                if f.default is not dataclasses.MISSING:
                    new_defaults[name] = f.default
                elif f.default_factory is not dataclasses.MISSING:
                    new_defaults[name] = _CallFactory(f.default_factory)
                else:
                    new_defaults[name] = _MISSING_SENTINEL
            elif not hasattr(some_class, name):
                new_defaults[name] = _MISSING_SENTINEL
            else:
                # default inherited from a not-yet-expanded base: a raw
                # `field(...)` or mutable container living on the base
                # class must be re-emitted on THIS class, else dataclass
                # processing delattr-fails / shares the mutable.
                inherited = getattr(some_class, name)
                if isinstance(inherited, dataclasses.Field):
                    if inherited.default is not dataclasses.MISSING:
                        new_defaults[name] = inherited.default
                    elif (
                        inherited.default_factory is not dataclasses.MISSING
                    ):
                        new_defaults[name] = _CallFactory(
                            inherited.default_factory
                        )
                    else:
                        new_defaults[name] = _MISSING_SENTINEL
                elif isinstance(inherited, (list, dict, set)):
                    new_defaults[name] = _ValueFactory(inherited)

    some_class.__annotations__ = new_annotations
    for k, v in new_defaults.items():
        if v is _MISSING_SENTINEL:
            if hasattr(some_class, k):
                delattr(some_class, k)
            continue
        if isinstance(v, _DefaultFactory):
            setattr(
                some_class, k, dataclasses.field(default_factory=v)
            )
        elif isinstance(v, (_ValueFactory, _CallFactory)):
            setattr(
                some_class, k, dataclasses.field(default_factory=v)
            )
        else:
            setattr(some_class, k, v)

    some_class._processed_members = processed
    # If the class was already a dataclass (manual decoration), drop the
    # stale generated methods: dataclasses.dataclass will NOT overwrite an
    # existing __init__ in the class __dict__.
    if dataclasses.is_dataclass(some_class):
        for attr in ("__init__", "__repr__"):
            if attr in some_class.__dict__:
                delattr(some_class, attr)
    dataclasses.dataclass(eq=False)(some_class)
    if issubclass(some_class, torch.nn.Module):
        _fixup_class_init(some_class)
    # Drop the `member = None` class attrs the member fields leave behind:
    # on torch.nn.Module Configurables the class attr would shadow the
    # _modules entry run_auto_creation registers (nn.Module.__getattr__ only
    # fires when ordinary lookup fails).  Instances still get the None
    # default from the generated __init__.
    for name in processed:
        if some_class.__dict__.get(name, _MISSING_SENTINEL) is None:
            delattr(some_class, name)
    return some_class


_MISSING_SENTINEL = object()


class _DefaultFactory:
    """default_factory producing a child config dict (late-bound so impls
    registered later still expand).  `tweak` is the owner class's
    `<member>_tweak_args(member_type, args)` hook, applied to the defaults
    at factory time."""

    def __init__(self, klass: type, tweak=None) -> None:
        self.klass = klass
        self.tweak = tweak

    def __call__(self) -> dict:
        args = get_default_args(self.klass)
        if self.tweak is not None:
            self.tweak(self.klass, args)
        return args


class _ValueFactory:
    def __init__(self, value) -> None:
        self.value = value

    def __call__(self):
        import copy

        return copy.deepcopy(self.value)


class _CallFactory:
    """Wraps a user default_factory so the setattr stage re-emits it as a
    dataclasses.field(default_factory=...)."""

    def __init__(self, fn) -> None:
        self.fn = fn

    def __call__(self):
        return self.fn()


def run_auto_creation(self) -> None:
    """Create all expanded child members of `self` from its args fields."""
    cls = type(self)
    expand_args_fields(cls)
    for name, (kind, base, is_optional) in cls._processed_members.items():
        if kind == "configurable":
            if is_optional and not getattr(self, name + ENABLED_SUFFIX, True):
                setattr(self, name, None)
                continue
            args = getattr(self, name + ARGS_SUFFIX, {}) or {}
            setattr(self, name, base(**args))
        elif kind == "replaceable":
            class_type = getattr(self, name + CLASS_TYPE_SUFFIX, None)
            if class_type in (None, "", "None"):
                setattr(self, name, None)
                continue
            impl = registry.get(base, class_type)
            expand_args_fields(impl)
            args = getattr(self, f"{name}_{class_type}{IMPL_SUFFIX}", {}) or {}
            setattr(self, name, impl(**args))


def get_default_args_field(C):
    """A dataclasses.field whose default is C's default args."""
    return dataclasses.field(default_factory=lambda: get_default_args(C))


def remove_unused_components(cfg: Dict[str, Any]) -> None:
    """Prune the `x_<Impl>_args` entries that `x_class_type` does not
    select, recursively.  Mutates the dict."""
    keys = list(cfg.keys())
    class_types = {
        k[: -len(CLASS_TYPE_SUFFIX)]: v
        for k, v in cfg.items()
        if k.endswith(CLASS_TYPE_SUFFIX)
    }
    for k in keys:
        for member, selected in class_types.items():
            prefix = member + "_"
            if (
                k.startswith(prefix)
                and k.endswith(IMPL_SUFFIX)
                and k != member + CLASS_TYPE_SUFFIX
                and k != f"{member}_{selected}{IMPL_SUFFIX}"
                and k != member + ARGS_SUFFIX
            ):
                del cfg[k]
    for v in cfg.values():
        if isinstance(v, dict):
            remove_unused_components(v)
