"""A read's signal mapped to its reference, and training chunks cut from
it (port of the reader side of taiyaki_tpu/data/signal_mapping.py).

Mapped-signal file fields (format v8): read_id (str), shift_frompA,
scale_frompA, range, offset, digitisation (float), Dacs (int16),
Ref_to_signal (int32), Reference (int16), and optionally mapping_score,
mapping_method.  len(Ref_to_signal) == len(Reference) + 1, monotone;
Ref_to_signal[n] is where base n starts in the untrimmed Dacs, unmapped
head positions are -1 and unmapped tail positions siglen + 1.

Chunk sampling draws from numpy's global random state, as the JAX package
does, so one seed draws the same chunks in both packages.
"""

import numpy as np

REQUIRED_FIELDS = {
    "read_id": str,
    "shift_frompA": float,
    "scale_frompA": float,
    "range": float,
    "offset": float,
    "digitisation": float,
    "Dacs": np.int16,
    "Ref_to_signal": np.int32,
    "Reference": np.int16,
}
OPTIONAL_FIELDS = {
    "mapping_score": float,
    "mapping_method": str,
}


class Chunk:
    """A candidate training chunk with its filter verdict."""

    _tiny = 1e-8

    rej_str_pass = "pass"
    rej_str_empty_seq = "emptysequence"
    rej_str_empty_sig = "emptysignal"
    rej_str_short = "tooshort"
    rej_str_null_map = "nullmapping"
    rej_str_path_buffer = "pathbuffer"
    rej_str_mean_dwl = "meandwell"
    rej_str_max_dwl = "maxdwell"

    def __init__(self, read_id, current=None, sequence=None, max_dwell=None,
                 start_sample=None, reject_reason=None):
        self.read_id = read_id
        self.current = current
        self.sequence = sequence
        self.max_dwell = max_dwell
        self.start_sample = start_sample
        self.reject_reason = (self.rej_str_pass if reject_reason is None
                              else reject_reason)

    @property
    def accepted(self):
        return self.reject_reason == self.rej_str_pass

    @property
    def seq_len(self):
        return 0 if self.sequence is None else len(self.sequence)

    @property
    def sig_len(self):
        return 0 if self.current is None else len(self.current)

    @property
    def mean_dwell(self):
        return self.sig_len / (self.seq_len + self._tiny)

    def apply_filters(self, filter_params):
        """Path-buffer, mean-dwell and max-dwell filters, setting
        reject_reason; no-op for a chunk already rejected or while the
        filter statistics are unset.  A None threshold disables its
        filter."""
        fp = filter_params
        if (not self.accepted or fp.median_meandwell is None
                or fp.mad_meandwell is None or fp.model_stride is None
                or fp.path_buffer is None):
            return
        if (self.sig_len / (self.seq_len * fp.model_stride)
                <= fp.path_buffer):
            self.reject_reason = self.rej_str_path_buffer
            return
        if (fp.filter_mean_dwell is not None
                and abs(self.mean_dwell - fp.median_meandwell)
                > fp.filter_mean_dwell * fp.mad_meandwell):
            self.reject_reason = self.rej_str_mean_dwl
            return
        if (fp.filter_max_dwell is not None
                and self.max_dwell
                > fp.filter_max_dwell * fp.median_meandwell):
            self.reject_reason = self.rej_str_max_dwl


class SignalMapping:
    """A read's raw signal together with its alignment to a reference."""

    pass_str = "pass"

    def __init__(self, Ref_to_signal, Reference, *, shift_frompA,
                 scale_frompA, range, offset, digitisation, read_id, Dacs,
                 mapping_score=None, mapping_method=None):
        self.Ref_to_signal = np.asarray(Ref_to_signal).astype(np.int32)
        self.Reference = np.asarray(Reference).astype(np.int16)
        self.shift_frompA = float(shift_frompA)
        self.scale_frompA = float(scale_frompA)
        self.range = float(range)
        self.offset = float(offset)
        self.digitisation = float(digitisation)
        self.read_id = str(read_id)
        self.Dacs = np.asarray(Dacs).astype(np.int16)
        self.mapping_score = (None if mapping_score is None
                              else float(mapping_score))
        self.mapping_method = (None if mapping_method is None
                               else str(mapping_method))

    @property
    def reflen(self):
        return self.Reference.shape[0]

    @property
    def siglen(self):
        return self.Dacs.shape[0]

    def check(self):
        """Integrity check; 'pass' or a description of the problems."""
        problems = []
        if len(self.Ref_to_signal) != self.reflen + 1:
            problems.append(
                "Length of Ref_to_signal ({}) should be 1 + length of "
                "Reference ({})".format(len(self.Ref_to_signal), self.reflen))
        if len(self.Ref_to_signal) > 0:
            if (self.Ref_to_signal.min() < -1
                    or self.Ref_to_signal.max() > self.siglen + 1):
                problems.append(
                    "Range of locations in mapping exceeds length of Dacs")
            if np.any(np.diff(self.Ref_to_signal) < 0):
                problems.append("Mapping does not increase monotonically")
        if not problems:
            return self.pass_str
        return "\n".join(problems) + "\n"

    # -- regions & currents --------------------------------------------------

    def _valid_map_mask(self):
        return (self.Ref_to_signal >= 0) & (self.Ref_to_signal <= self.siglen)

    def get_mapped_reference_region(self):
        """(start, end) of reference positions that are mapped."""
        valid = np.flatnonzero(self._valid_map_mask())
        if len(valid) == 0:
            return 0, 0
        return int(valid[0]), int(valid[-1])

    def get_mapped_dacs_region(self):
        """(start, end) of signal samples covered by the mapping."""
        vals = self.Ref_to_signal[self._valid_map_mask()]
        if len(vals) == 0:
            return 0, 0
        return int(vals[0]), int(vals[-1])

    def get_reference_locations(self, signal_region):
        """Reference (start, end) covering a signal (start, end) region:
        the base whose signal spans the region start is included, slip
        bases at the end are not."""
        sig_start, sig_end = int(signal_region[0]), int(signal_region[1])
        d_start, d_end = self.get_mapped_dacs_region()
        if sig_start < d_start:
            raise IndexError("Signal location before mapped region requested.")
        if sig_end > d_end:
            raise IndexError("Signal location after mapped region requested.")
        seq_start = np.searchsorted(self.Ref_to_signal, sig_start,
                                    "right") - 1
        seq_end = np.searchsorted(self.Ref_to_signal, sig_end, "left")
        return np.array([seq_start, seq_end])

    def get_current(self, region=None, standardize=True):
        """Signal in pA (or standardized units) over a region."""
        dacs = self.Dacs if region is None else \
            self.Dacs[region[0]:region[1]]
        current = (dacs + self.offset) * self.range / self.digitisation
        if standardize:
            current = (current - self.shift_frompA) / self.scale_frompA
        return current

    # -- chunks ---------------------------------------------------------------

    def _get_chunk(self, dacs_region, ref_region, standardize=True):
        if ref_region[1] == ref_region[0]:
            return Chunk(self.read_id,
                         reject_reason=Chunk.rej_str_empty_seq)
        if dacs_region[1] == dacs_region[0]:
            return Chunk(self.read_id,
                         reject_reason=Chunk.rej_str_empty_sig)
        current = self.get_current(dacs_region, standardize)
        reference = self.Reference[ref_region[0]:ref_region[1]]
        dwells = np.diff(self.Ref_to_signal[ref_region[0]:ref_region[1]])
        max_dwell = int(dwells.max()) if len(dwells) > 0 else 1
        return Chunk(self.read_id, current, reference, max_dwell,
                     int(dacs_region[0]))

    def get_chunk_with_sample_length(self, chunk_len, start_sample=None,
                                     standardize=True):
        """Chunk of exactly chunk_len signal samples; its sequence follows
        from the mapping.  Random start if start_sample is None."""
        d_start, d_end = self.get_mapped_dacs_region()
        spare = d_end - d_start - chunk_len
        if spare <= 0 or (start_sample is not None and start_sample >= spare):
            return Chunk(self.read_id, reject_reason=Chunk.rej_str_short)
        if start_sample is None:
            chunk_start = d_start + np.random.randint(spare)
        else:
            chunk_start = d_start + start_sample
        dacs_region = (chunk_start, chunk_start + chunk_len)
        try:
            ref_region = self.get_reference_locations(dacs_region)
        except IndexError:
            return Chunk(self.read_id, reject_reason=Chunk.rej_str_null_map)
        return self._get_chunk(dacs_region, ref_region, standardize)

    def get_chunk_with_sequence_length(self, chunk_bases, start_base=None,
                                       standardize=True):
        """Chunk of exactly chunk_bases reference bases; its signal
        follows from the mapping.  Random start if start_base is None."""
        r_start, r_end = self.get_mapped_reference_region()
        spare = r_end - r_start - chunk_bases
        if spare <= 0 or (start_base is not None and start_base >= spare):
            return Chunk(self.read_id, reject_reason=Chunk.rej_str_short)
        if start_base is None:
            ref_start = r_start + np.random.randint(spare)
        else:
            ref_start = r_start + start_base
        ref_region = (ref_start, ref_start + chunk_bases)
        dacs_region = (int(self.Ref_to_signal[ref_region[0]]),
                       int(self.Ref_to_signal[ref_region[1]]))
        return self._get_chunk(dacs_region, ref_region, standardize)
