"""capture_s: seconds the server spent warming up and capturing its
bucket graphs (``serve.BucketGraph.seconds``, summed). Moves setup_s."""


def read(rec):
    v = rec.get("capture_s")
    return None if not v else float(v)
