"""Plot the output of predict_squiggle (port of
misc/plot_predict_squiggle_output.py; host only, no device).

    python -m taiyaki_tpu_torch.cli.plot_predict_squiggle_output predicted.tsv out.png

Each row of the predicted squiggle (base, current, sd, dwell) as a bar
of width dwell around its current, labelled with its base.  Prints its
usage first, and returns without plotting when given fewer than two
arguments, as the JAX tool does.  Needs matplotlib: where it is not
installed, exits non-zero naming it and writes nothing.
"""

import sys

from taiyaki_tpu_torch.utils import fileio
from taiyaki_tpu_torch.utils.plotting import require_pyplot


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    print("Plots output of predict_squiggle.py\nUsage:\n"
          "plot_predict_squiggle_output.py <predict_squiggle_output_file> "
          "<output_png_file>")
    if len(argv) < 2:
        print("ERROR: Needs command line arguments!")
        return 0
    plt = require_pyplot("plot_predict_squiggle_output")
    table = fileio.readtsv(argv[0])
    plt.figure(figsize=(16, 5))
    tstart = 0
    for row in table:
        current, sd, dwell = row["current"], row["sd"], row["dwell"]
        centre = tstart + dwell / 2
        plt.bar(centre, sd, dwell, current - sd / 2)
        plt.text(centre, current, str(row["base"]))
        tstart += dwell
    plt.xlabel("time")
    plt.ylabel("current")
    plt.grid()
    plt.savefig(argv[1])
    plt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
