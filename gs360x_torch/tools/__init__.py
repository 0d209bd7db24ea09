"""CLI tools, flag-compatible with :mod:`gs360x.tools`."""
