"""Seconds from the process's start to the first measured step or request:
loading, making the weights, building the kernels where the checkout has not
yet, and warming the cell's shapes."""


def read(r):
    return r["run"]["setup_s"]
