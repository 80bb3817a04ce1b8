"""Host tools: the dictionary builder (``make_dict``, ``core_words``)."""
