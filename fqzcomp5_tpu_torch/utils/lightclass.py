"""Minimal dataclass replacement without the `inspect` import chain.

Stdlib `dataclasses` imports `inspect` (and its re/token machinery) —
~45ms of CLI cold-start on this image, paid by every `fqz5` run (the
reference binary boots in milliseconds).  The CLI-path modules use
only the plain decorator subset — annotated fields, simple defaults,
`field(default_factory=...)` — so this shim generates __init__,
__repr__ and __eq__ for exactly that subset the same way dataclasses
does (exec'd source), importing nothing.
"""

_MISSING = object()


class _Factory:
    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


def field(*, default_factory):
    return _Factory(default_factory)


def lightclass(cls):
    """Decorator: synthesize __init__/__repr__/__eq__ from annotations.

    Subset semantics of @dataclasses.dataclass: fields in annotation
    order; class-level values are defaults; _Factory defaults call
    their factory per instance.  No inheritance merging (none of the
    CLI classes subclass another lightclass)."""
    anns = cls.__dict__.get("__annotations__", {})
    names = list(anns)
    defaults = {}
    factories = {}
    for name in names:
        v = cls.__dict__.get(name, _MISSING)
        if isinstance(v, _Factory):
            factories[name] = v.fn
        elif v is not _MISSING:
            defaults[name] = v
    args = ["self"]
    body = []
    seen_default = False
    for n in names:
        if n in factories:
            args.append(f"{n}=_MISSING")
            body.append(f"    self.{n} = _FAC[{n!r}]() "
                        f"if {n} is _MISSING else {n}")
            seen_default = True
        elif n in defaults:
            args.append(f"{n}=_DEF[{n!r}]")
            body.append(f"    self.{n} = {n}")
            seen_default = True
        else:
            if seen_default:
                raise TypeError(
                    f"non-default field {n!r} follows a default field")
            args.append(n)
            body.append(f"    self.{n} = {n}")
    src = f"def __init__({', '.join(args)}):\n"
    src += "\n".join(body) if body else "    pass"
    ns = {"_FAC": factories, "_DEF": defaults, "_MISSING": _MISSING}
    exec(src, ns)  # noqa: S102 — same technique as stdlib dataclasses
    cls.__init__ = ns["__init__"]

    def __repr__(self):
        parts = ", ".join(f"{n}={getattr(self, n)!r}" for n in names)
        return f"{cls.__name__}({parts})"

    def __eq__(self, other):
        if other.__class__ is not self.__class__:
            return NotImplemented
        return all(getattr(self, n) == getattr(other, n) for n in names)

    if "__repr__" not in cls.__dict__:
        cls.__repr__ = __repr__
    if "__eq__" not in cls.__dict__:
        cls.__eq__ = __eq__
        cls.__hash__ = None
    cls.__lightclass_fields__ = tuple(names)
    return cls


# drop-in alias so call sites read the same as stdlib dataclasses
dataclass = lightclass
