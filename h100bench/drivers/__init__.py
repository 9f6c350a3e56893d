"""Drivers: how a traffic mix drives the program.  A traffic file names its
driver (``"driver": "train"``); each module here has a ``Driver`` with
``setup``, ``window``, ``traced``, ``release`` and ``check``."""
