"""One module per kind of traffic loop; a traffic file names its loop.

Each module's ``Loop(run)`` has ``setup()``, ``step(i, annotate) -> work``,
``metrics(window)``, ``context(window)``, ``finish(window) -> (attempted,
failed)``, ``release()`` and ``check() -> [Check]`` (see
``klbench/harness.py``).
"""
