"""The port's native C++ text parser (lgbm_native.cpp), built with g++ at
first use into the package's git-ignored ``_build/`` and loaded with
ctypes (lib.py)."""
