"""On-disk formats written and read by the port."""
from .kmc_db import (
    DbInfo,
    KmcDb,
    Kmc2DbWriter,
    read_db,
    sorted_records,
    write_kmc1_db,
    pick_lut_prefix_len,
    kmers_bytes_to_strings,
)
from .dump import dump_db, dump_db_file, dump_records
