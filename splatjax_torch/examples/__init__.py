"""The user-facing demos of the port (PyTorch ports of splatjax's
``examples/``), each run as ``python -m splatjax_torch.examples.<name>``.

Every module's ``main(argv=None)`` parses splatjax's arguments plus
``--device`` (default ``cuda``; it raises without a card unless given
``cpu``) and returns a dict of what it made: frames as CPU numpy arrays,
the paths it wrote, and its metrics. Nothing runs at import.
"""
