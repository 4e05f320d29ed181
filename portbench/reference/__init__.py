"""Plain PyTorch references of the benchmark's configurations, in float32
with TF32 off. They import nothing of the port: they take the benchmark's
weights and inputs and work out again whatever the port derives from them.
"""
