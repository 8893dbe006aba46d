"""The loops that drive the port's entries, one module a driver; a mix's
``"driver"`` names its module.  Each module has ``Driver(model, cfg, mix,
videos, sample, device)`` with ``warm()``, ``window(seconds)``,
``profiled()`` and ``stages()``."""
