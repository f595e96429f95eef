"""Host I/O: the ring history, synthetic sources, the FPGA wire format,
pcap replay, UDP and native ingest, WAV/MP3/playback, gpsd and checkpoints."""
