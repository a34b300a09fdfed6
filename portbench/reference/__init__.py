"""The plain reference the benchmark holds the program against.

Plain PyTorch: a frozen copy of the threefry coloring draw
(:mod:`.threefry`), the R-MAT generator that makes each run's graph from its
seed (:mod:`.rmat`), and the color-coding counts (:mod:`.colorcoding`).  It
imports nothing of the program under test.
"""
