"""upload_copy_s.train: seconds per training job in the program's span
"upload: copy to device" (sparse.DocSparse.from_doc_sorted: the
corpus's three arrays copied from pageable host memory to the card),
inside the stage "upload A to device"."""

from portbench.spans import span_mean


def read(ctx):
    return span_mean(ctx, "upload: copy to device")
