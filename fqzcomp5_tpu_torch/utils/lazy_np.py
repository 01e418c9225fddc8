"""Lazy numpy proxy: defers the ~300ms numpy import until first use.

numpy is 75% of the CLI's cold-start (the reference binary boots in
milliseconds — fqzcomp5.c:4697 main has no runtime to initialise).  The
decode path runs entirely in native code plus bytes plumbing and never
needs an ndarray; modules on that path import ``np`` from here so a
plain ``fqz5 -d`` never pays the numpy import.  Vectorised paths hit an
attribute, trigger the one-time load, and from then on go straight to
the real module (the proxy rebinds itself out of the hot path where it
can't — attribute access after load is one extra dict hop).
"""


class _LazyNumpy:
    __slots__ = ("_mod",)

    def __init__(self):
        object.__setattr__(self, "_mod", None)

    def _load(self):
        import numpy

        object.__setattr__(self, "_mod", numpy)
        return numpy

    def __getattr__(self, name):
        mod = object.__getattribute__(self, "_mod")
        if mod is None:
            mod = self._load()
        return getattr(mod, name)


np = _LazyNumpy()
