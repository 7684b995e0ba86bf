"""reader.us_per_read (reader): time in ``RawFastqReader.next_batch``
(gzip, ``bt_scan_fastq``) per read in the window."""


def read(run):
    return run.us_per_read("reader.next_batch")
