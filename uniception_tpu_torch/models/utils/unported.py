"""
Registry entries for modules of the JAX package that the port does not build yet.
"""

__all__ = ["not_ported"]


def not_ported(name: str, roadmap_item: str) -> type:
    """A class standing in a registry for the JAX package's ``name``: constructing it raises NotImplementedError
    naming the ROADMAP item that ports it. ``roadmap_item`` is kept on the class for listings."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{name} is not ported to uniception_tpu_torch yet (ROADMAP {roadmap_item})")

    return type(f"NotPorted[{name}]", (), {"__init__": __init__, "roadmap_item": roadmap_item, "__doc__":
                                           f"{name}: not ported yet (ROADMAP {roadmap_item})."})
