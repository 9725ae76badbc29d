from . import synthetic  # noqa: F401 (registry side effect)
