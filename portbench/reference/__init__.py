"""Plain float32 reference of one tracker step, in plain PyTorch and numpy.

A frozen copy of the port's plain path (preprocess, the YOLOX detector on
its modules, decode, class-aware NMS, fixed-point corner-guided depth, the
OC-SORT tracker with its Jonker-Volgenant assignment), kept here so that
the benchmark's yardstick does not move when the program does.  It imports
nothing of the program and takes nothing the program made: the benchmark
hands it the same seed-made weights and frames it hands the program.
"""
