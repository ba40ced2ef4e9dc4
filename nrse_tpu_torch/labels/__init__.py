"""MSP-Podcast label lists."""
