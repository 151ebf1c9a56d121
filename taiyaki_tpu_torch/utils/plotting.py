"""matplotlib where it is installed: the card's host has none, so a tool
imports it only to write a plot."""

import sys


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def require_pyplot(tool):
    """pyplot() for a tool that only plots; exits non-zero, naming
    matplotlib and writing nothing, where it is not installed."""
    plt = pyplot()
    if plt is None:
        sys.exit("* Error: {} plots with matplotlib, which is not "
                 "installed: no plot written".format(tool))
    return plt
