"""Training-chunk sampling and filter-parameter estimation (port of
taiyaki_tpu/data/chunk_selection.py).  Reads are drawn with numpy's
global random state, as in the JAX package."""

from collections import defaultdict, namedtuple

import numpy as np

from taiyaki_tpu_torch.maths import med_mad


class FILTER_PARAMETERS(namedtuple("FILTER_PARAMETERS", (
        "filter_mean_dwell", "filter_max_dwell", "filter_min_pass_fraction",
        "median_meandwell", "mad_meandwell", "model_stride",
        "path_buffer"))):
    """Chunk filter settings and the dwell statistics taken from data.

    filter_mean_dwell: reject if |mean dwell - median| > this many MADs.
    filter_max_dwell: reject if max dwell > this multiple of the median.
    filter_min_pass_fraction: sampling gives up after
        number_to_sample / this many attempts.
    median_meandwell / mad_meandwell: from sample_filter_parameters.
    model_stride / path_buffer: reject if sig_len/(seq_len*stride) <= buffer
        (the chunk's sequence would not fit through the CRF lattice).
    """


def sample_chunks(read_data, number_to_sample, chunk_len, filter_params,
                  chunk_len_means_sequence_len=False, standardize=True,
                  select_strands_randomly=True, first_strand_index=0):
    """Sample chunks until number_to_sample pass the filters (or the retry
    budget number_to_sample/filter_min_pass_fraction is spent).

    Returns:
        (chunks, rejection_counts): counts by reject reason, 'pass'
        included.
    """
    nreads = len(read_data)
    target = (nreads if not number_to_sample else number_to_sample)
    max_attempts = int(target / filter_params.filter_min_pass_fraction)
    chunks = []
    rejection_reasons = defaultdict(int)
    attempts = 0
    while len(chunks) < target and attempts < max_attempts:
        if select_strands_randomly:
            read = read_data[np.random.randint(nreads)]
        else:
            read = read_data[(first_strand_index + attempts) % nreads]
        attempts += 1
        if chunk_len_means_sequence_len:
            chunk = read.get_chunk_with_sequence_length(
                chunk_len, standardize=standardize)
        else:
            chunk = read.get_chunk_with_sample_length(
                chunk_len, standardize=standardize)
        chunk.apply_filters(filter_params)
        rejection_reasons[chunk.reject_reason] += 1
        if chunk.accepted:
            chunks.append(chunk)
    return chunks, rejection_reasons


def sample_filter_parameters(read_data, number_to_sample, chunk_len,
                             filter_mean_dwell, filter_max_dwell,
                             filter_min_pass_fraction, model_stride,
                             path_buffer,
                             chunk_len_means_sequence_len=False):
    """Median and MAD of chunk mean dwell from a sample of unfiltered
    chunks, with the settings, as FILTER_PARAMETERS."""
    unfiltered = FILTER_PARAMETERS(
        filter_mean_dwell=filter_mean_dwell,
        filter_max_dwell=filter_max_dwell,
        filter_min_pass_fraction=filter_min_pass_fraction,
        median_meandwell=None, mad_meandwell=None,
        model_stride=None, path_buffer=None)
    chunks, _ = sample_chunks(
        read_data, number_to_sample, chunk_len, unfiltered,
        chunk_len_means_sequence_len=chunk_len_means_sequence_len)
    meandwells = [c.mean_dwell for c in chunks]
    median_meandwell, mad_meandwell = med_mad(meandwells)
    return FILTER_PARAMETERS(
        filter_mean_dwell=filter_mean_dwell,
        filter_max_dwell=filter_max_dwell,
        filter_min_pass_fraction=filter_min_pass_fraction,
        median_meandwell=median_meandwell, mad_meandwell=mad_meandwell,
        model_stride=model_stride, path_buffer=path_buffer)
