"""Implicitron's configuration markers (port of the two base classes of
pytorch3d_tpu/implicitron/tools/config.py).  The registry, `get_default_args`,
`expand_args_fields` and `run_auto_creation` are not ported yet."""


class ReplaceableBase:
    """Base for plugin hierarchies whose members are chosen by a
    `<member>_class_type` string."""


class Configurable:
    """Base for config dataclasses whose members are built from their
    arguments."""
