"""drivers"""
