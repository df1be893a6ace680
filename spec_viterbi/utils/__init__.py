"""Utilities: operator-cache persistence, compile cache, profiling helpers."""

from spec_viterbi.utils.cache import OperatorCache
from spec_viterbi.utils.compile_cache import enable_persistent_cache
from spec_viterbi.utils.profiling import trace, StepTimer

__all__ = ["OperatorCache", "enable_persistent_cache", "trace", "StepTimer"]
