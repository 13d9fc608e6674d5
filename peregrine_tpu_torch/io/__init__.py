from .seqdb import SeqDB, encode_biseq, decode_biseq, read_fastx  # noqa: F401
