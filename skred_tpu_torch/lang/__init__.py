from skred_tpu_torch.lang.skode import Skode, FUNCTION, DEFER, CHUNK_END, GOT_STRING, GOT_ARRAY, PUSH, POP  # noqa: F401
