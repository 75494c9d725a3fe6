"""The benchmark's plain reference of the zip-nerf train step and render:
a frozen copy of the port's plain PyTorch path (the modules named as in
the port), with the hash encode by `table[idx]` under PyTorch's autograd
and the trunks as plain matmul chains. It imports no module of the port
and no kernel; the harness compares the port against it.
"""
